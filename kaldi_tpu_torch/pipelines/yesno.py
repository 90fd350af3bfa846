"""The yesno-equivalent end-to-end recipe, runnable as a module:

    python -m kaldi_tpu_torch.pipelines.yesno [--num-utts=30] [--num-iters=12]
        [--device=cuda]

Port of kaldi_tpu/pipelines/yesno.py (parity target egs/yesno/s5/run.sh:
data prep → MFCC+CMVN → mono GMM train → HCLG → decode → score,
expected %WER 0.00) on the port: MFCC through the fbank kernel, CMVN
and deltas on ``device``, then train_mono (GMM kernel, aligner and
accumulators on the device) and the dense decoder.  The corpus is the
synthetic one of pipelines/data.py.
"""

from __future__ import annotations

import sys

import torch

from kaldi_tpu_torch.core.logging import Timer, get_logger
from kaldi_tpu_torch.core.options import ParseOptions
from kaldi_tpu_torch.decoder.beam import BeamDecoderConfig
from kaldi_tpu_torch.device import resolve_device
from kaldi_tpu_torch.features import (
    DeltaFeaturesOptions,
    FrameExtractionOptions,
    MelBanksOptions,
    Mfcc,
    MfccOptions,
    add_deltas,
    apply_cmvn,
    compute_cmvn_stats,
)
from kaldi_tpu_torch.fst import (ArpaModel, Lang, arpa_to_fst,
                                 make_unigram_arpa, mkgraph)
from kaldi_tpu_torch.pipelines.data import (make_synthetic_dataset,
                                            yesno_lexicon)
from kaldi_tpu_torch.pipelines.decode import decode_gmm
from kaldi_tpu_torch.pipelines.mono import MonoTrainConfig, train_mono

log = get_logger(__name__)


def cmvn_per_speaker(data, raw):
    """Per-speaker CMVN (compute_cmvn_stats.sh --spk2utt, apply-cmvn) of
    raw features utt → (T, D) tensor."""
    spk_stats = {spk: sum(compute_cmvn_stats(raw[u]) for u in utts)
                 for spk, utts in data.spk2utt().items()}
    return {u: apply_cmvn(raw[u], spk_stats[data.utt2spk[u]])
            for u in data.utts}


def make_feats(data, samp_freq=8000.0, num_mel=15, num_ceps=10,
               device: torch.device | str = "cuda"):
    """MFCC + per-speaker CMVN + deltas (steps/make_mfcc.sh +
    compute_cmvn_stats.sh + add-deltas feature pipe) on ``device`` →
    utt → (T, 3·num_ceps) float32 numpy on the host."""
    mfcc = Mfcc(MfccOptions(
        frame_opts=FrameExtractionOptions(samp_freq=samp_freq, dither=0.0),
        mel_opts=MelBanksOptions(num_bins=num_mel), num_ceps=num_ceps),
        device=device)
    raw = {u: mfcc.compute(data.wavs[u][0] * 32768.0) for u in data.utts}
    normed = cmvn_per_speaker(data, raw)
    return {u: add_deltas(normed[u], DeltaFeaturesOptions()).cpu().numpy()
            for u in data.utts}


def run(num_utts: int = 30, num_test: int = 10, num_iters: int = 12,
        totgauss: int = 120, beam: float = 16.0, acoustic_scale: float = 0.1,
        device: torch.device | str = "cuda", report=None,
        return_system: bool = False):
    """The recipe on ``device``; ``report`` goes to train_mono.  Returns
    the decode result (its ``wer`` against the test transcripts), and
    with ``return_system`` also a dict of what the recipe built (the
    model, the data sets and their features, the graph, the decoder
    config), for scoring other sets with the same system."""
    device = resolve_device(device)
    timer = Timer()
    lex = yesno_lexicon()
    train = make_synthetic_dataset(lex, num_utts=num_utts, max_words=4, seed=1)
    test = make_synthetic_dataset(lex, num_utts=num_test, max_words=4, seed=2)
    lang = Lang(lex)
    log.info("stage 0: data prepared (%d train / %d test utts)",
             num_utts, num_test)

    train_feats = make_feats(train, device=device)
    test_feats = make_feats(test, device=device)
    log.info("stage 1: features done (%.1fs)", timer.elapsed())

    cfg = MonoTrainConfig(num_iters=num_iters, totgauss=totgauss,
                          realign_iters=tuple(range(1, num_iters, 2)))
    model = train_mono(train_feats, train.text, lang, cfg, device=device,
                       report=report)
    log.info("stage 2: mono training done (%.1fs)", timer.elapsed())

    arpa = ArpaModel.parse(make_unigram_arpa({"YES": 1.0, "NO": 1.0}))
    HCLG = mkgraph(lang, model.tm, arpa_to_fst(arpa, lang.words))
    log.info("stage 3: HCLG built: %s", HCLG)

    dcfg = BeamDecoderConfig(beam=beam, max_active=200,
                             acoustic_scale=acoustic_scale)
    result = decode_gmm(test_feats, model.am, model.tm, HCLG, lang, dcfg,
                        refs=test.text, device=device)
    log.info("stage 4: decode done (%.1fs total)", timer.elapsed())
    print(result.wer)
    if return_system:
        return result, {"model": model, "lang": lang, "HCLG": HCLG,
                        "train": train, "test": test,
                        "train_feats": train_feats, "test_feats": test_feats,
                        "dcfg": dcfg}
    return result


def main(argv=None):
    po = ParseOptions("Usage: python -m kaldi_tpu_torch.pipelines.yesno "
                      "[options]")
    po.register("num-utts", int, 30, "Number of training utterances")
    po.register("num-iters", int, 12, "Training iterations")
    po.register("totgauss", int, 120, "Target total Gaussians")
    po.register("beam", float, 16.0, "Decoding beam")
    po.register("acoustic-scale", float, 0.1, "Acoustic scale")
    po.register("device", str, "cuda", "torch device to run on")
    po.read(argv)
    result = run(num_utts=po["num-utts"], num_iters=po["num-iters"],
                 totgauss=po["totgauss"], beam=po["beam"],
                 acoustic_scale=po["acoustic-scale"], device=po["device"])
    return 0 if result.wer.wer == 0.0 else 1


if __name__ == "__main__":
    sys.exit(main())
