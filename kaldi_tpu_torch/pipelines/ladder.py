"""Port of kaldi_tpu/pipelines/ladder.py: the falsifiable WER ladder,
mono → tri1 → tri2b → tri3b → chain on a HARD synthetic corpus
(confusable minimal-pair lexicon, waveform noise, per-speaker formant
warps, heldout test speakers).

Parity target: the reference's RESULTS-file contract
(egs/mini_librispeech/s5/RESULTS): each system must beat the previous
on a task with nonzero WER.

Runnable:  python -m kaldi_tpu_torch.pipelines.ladder [--device=cuda]
Prints a stage→WER table with Wilson intervals.  The GMM rungs are the
port's ``mini.run`` on ``device``; the chain rung builds its den graph
and egs on the host, trains with ``ChainTrainer`` (the den kernels on a
card) and decodes with ``DenseDecoder`` on ``device``.
"""

from __future__ import annotations

import sys
from typing import Dict

import torch

from kaldi_tpu_torch.am.chain import make_denominator_graph
from kaldi_tpu_torch.am.tdnn import TdnnConfig
from kaldi_tpu_torch.am.topology import HmmTopology
from kaldi_tpu_torch.am.transitions import TransitionModel
from kaldi_tpu_torch.am.tree import MonophoneContextDependency
from kaldi_tpu_torch.core.logging import Timer, get_logger
from kaldi_tpu_torch.core.options import ParseOptions
from kaldi_tpu_torch.decoder.dense import DenseDecoder, DenseDecoderConfig
from kaldi_tpu_torch.device import resolve_device
from kaldi_tpu_torch.fst import mkgraph
from kaldi_tpu_torch.pipelines import mini
from kaldi_tpu_torch.pipelines.chain import (ChainTrainConfig, ChainTrainer,
                                             make_chain_egs,
                                             phone_alignment_runs)
from kaldi_tpu_torch.pipelines.score import compute_wer, wilson_interval

log = get_logger(__name__)


# Port of kaldi_tpu/pipelines/ladder.py chain_stage (+ device, stats,
# keep).
def chain_stage(sysd: Dict, order: int, num_epochs: int = 40,
                hidden: int = 96, seed: int = 0,
                device: torch.device | str = "cuda", stats=None,
                keep=None):
    """Train + decode an LF-MMI TDNN on the ladder's data, with an
    order-`order` denominator phone LM, on ``device``.

    Supervision comes from the tri3b (SAT) alignments and the features
    are the fMLLR-adapted SAT front-end — the reference's chain recipes
    likewise build supervision from the best GMM and feed the nnet the
    best front-end (steps/nnet3/chain/get_egs.sh uses tri3b lats;
    test-side transforms come from the GMM first pass, the
    decode_fmllr.sh contract).  ``stats``, a dict, receives the final
    training step's diagnostics; ``keep``, a dict, the trained model
    (``model``, ``config``), the chain transition model (``tm``) and the
    decoding graph (``HCLG``)."""
    device = resolve_device(device)
    lang = sysd["lang"]
    test = sysd["test"]
    feats_tr, feats_te = sysd["sat_tr"], sysd["sat_te"]
    gmm_sys = sysd["tri3b"]
    ali = sysd["tri3b_ali"]

    phones = lang.phone_list()
    chain_topo = HmmTopology.chain(phones)
    chain_tree = MonophoneContextDependency(phones, chain_topo)
    phone_seqs = [gmm_sys.tm.alignment_to_phones(ali[u])
                  for u in sorted(ali)]
    den = make_denominator_graph(phone_seqs, chain_tree, chain_topo,
                                 order=order)
    runs = {u: phone_alignment_runs(gmm_sys.tm, ali[u]) for u in ali}
    feat_dim = next(iter(feats_tr.values())).shape[1]
    egs = make_chain_egs(feats_tr, runs, chain_tree, chain_topo,
                         chunk_size=51, subsample=3, den=den)
    cfg = TdnnConfig(feat_dim=feat_dim, num_pdfs=chain_tree.num_pdfs,
                     hidden_dim=hidden, bottleneck_dim=hidden // 4,
                     num_layers=5, frame_subsampling_factor=3)
    trainer = ChainTrainer(cfg, den, ChainTrainConfig(
        num_epochs=num_epochs, batch_size=16, learning_rate=2e-3),
        seed=seed, device=device)
    final = trainer.train(egs, log_every=200)
    log.info("chain(order=%d): objf %.3f", order, final["objf"])
    if stats is not None:
        stats.update(final)

    tm_chain = TransitionModel(chain_topo, chain_tree)
    HCLG = mkgraph(lang, tm_chain, sysd["G"], self_loop_scale=1.0)
    if keep is not None:
        keep.update(model=trainer.model, config=cfg, tm=tm_chain, HCLG=HCLG)
    dec = DenseDecoder(HCLG, tm_chain.tid_to_pdf_array,
                       DenseDecoderConfig(beam=16.0, acoustic_scale=1.0),
                       device=device)
    scorer = trainer.scores_fn()
    hyps = {}
    for u in sorted(feats_te):
        scores = scorer(feats_te[u][None])[0]
        _, ols, _ = dec.decode(scores)
        hyps[u] = [lang.words.find(o) for o in ols]
    return compute_wer(test.text, hyps)


# Port of kaldi_tpu/pipelines/ladder.py run (+ device; the corpus's
# keywords from mini.ladder_corpus, which mini's CLI runs too).
def run(num_utts: int = 100, num_test: int = 30, seed: int = 1,
        noise: float = 0.12, speaker_warp: float = 0.12,
        chain_epochs: int = 40, coarticulation: float = 0.35,
        num_words: int = 0, device: torch.device | str = "cuda"):
    """``num_words`` ≥ 12 swaps the hand-written 12-word lexicon for a
    GENERATED confusable lexicon of that size (spectral-cluster
    minimal pairs, pipelines/flagship.flagship_lexicon) with a bigram
    G estimated from the training transcripts.  0 keeps the legacy
    12-word corpus."""
    timer = Timer()
    lexicon = formants = None
    lm_order = 1
    if num_words:
        from kaldi_tpu_torch.fst.lang import Lexicon
        from kaldi_tpu_torch.pipelines.flagship import flagship_lexicon
        entries, formants = flagship_lexicon(
            num_words, n_clusters=8, per_cluster=3, min_len=2,
            max_len=5, seed=seed + 17)
        lexicon = Lexicon(sorted(entries))
        lm_order = 2
    wers, sysd = mini.run(
        seed=seed, return_systems=True, lm_order=lm_order, device=device,
        **mini.ladder_corpus(num_utts, num_test, noise=noise,
                             speaker_warp=speaker_warp,
                             coarticulation=coarticulation,
                             lexicon=lexicon, formants=formants))
    # one chain system at the product default den-LM order (3, as
    # chain-est-phone-lm); the original retired its bigram rung
    wers["chain"] = chain_stage(sysd, order=3, num_epochs=chain_epochs,
                                device=device)
    print("\n== WER ladder (noise %.2f, warp %.2f, heldout speakers) =="
          % (noise, speaker_warp))
    for stage in ("mono", "tri1", "tri2b", "tri3b", "chain"):
        r = wers[stage]
        lo, hi = wilson_interval(r.errors, r.ref_words)
        print(f"  {stage:12s} {r}  wilson95=[{lo:.2f}, {hi:.2f}]")
    log.info("ladder done in %.0fs", timer.elapsed())
    return wers


# Port of kaldi_tpu/pipelines/ladder.py main (+ --device).
def main(argv=None):
    po = ParseOptions("Usage: python -m kaldi_tpu_torch.pipelines.ladder "
                      "[options]")
    po.register("num-utts", int, 100, "training utterances")
    po.register("num-test", int, 30, "test utterances")
    po.register("noise", float, 0.12, "waveform noise level")
    po.register("speaker-warp", float, 0.12, "per-speaker formant warp")
    po.register("chain-epochs", int, 40, "chain training epochs")
    po.register("num-words", int, 0,
                "generated confusable lexicon size (0 = legacy 12)")
    po.register("device", str, "cuda", "torch device to run on")
    po.read(argv)
    wers = run(num_utts=po["num-utts"], num_test=po["num-test"],
               noise=po["noise"], speaker_warp=po["speaker-warp"],
               chain_epochs=po["chain-epochs"],
               num_words=po["num-words"], device=po["device"])
    ladder = [wers[s].wer for s in
              ("mono", "tri1", "tri2b", "tri3b")]
    ok = wers["mono"].wer > 0 and ladder[-1] <= ladder[0]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
