"""End-to-end chain (LF-MMI TDNN) recipe, runnable as a module:

    python -m kaldi_tpu_torch.pipelines.chain_recipe [--device=cuda]

Port of kaldi_tpu/pipelines/chain_recipe.py (parity target: the
egs/*/local/chain/run_tdnn.sh flow): a mono GMM system for alignments →
chain topology + monophone tree → den phone-LM graph → egs → TDNN-F
LF-MMI training → decode with a self-loop-scale-1.0 graph at the
subsampled frame rate (nnet3-latgen-faster with
--frame-subsampling-factor=3).  On ``device``: MFCC through the fbank
kernel, the GMM kernel and the batched aligner, the chain training (den
kernels) and the dense decoder.  It exits 0 when the WER is below 20.

``--xconfig`` trains a model written in the xconfig language
(am/xconfig.py) instead of the built-in TDNN-F: a file, or ``default``
for ``default_xconfig``, the recipe's model as xconfig text.
"""

from __future__ import annotations

import sys

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
from kaldi_tpu_torch.features import add_deltas
from kaldi_tpu_torch.fst import (ArpaModel, Lang, arpa_to_fst,
                                 make_unigram_arpa, mkgraph)
from kaldi_tpu_torch.pipelines.chain import (ChainTrainConfig, ChainTrainer,
                                             make_chain_egs,
                                             phone_alignment_runs)
from kaldi_tpu_torch.pipelines.data import make_synthetic_dataset
from kaldi_tpu_torch.pipelines.mini import _on_device, base_feats, \
    mini_lexicon
from kaldi_tpu_torch.pipelines.mono import (MonoTrainConfig, realign,
                                            train_mono)
from kaldi_tpu_torch.pipelines.score import compute_wer

log = get_logger(__name__)


def gmm_alignments(model, feats, text, lang,
                   device: torch.device | str = "cuda"):
    """Every utterance's forced alignment under the GMM: one GMM launch
    over all frames and one batch of the aligner on ``device``."""
    from kaldi_tpu_torch.decoder.align import (DenseAligner,
                                               pack_training_graphs)
    from kaldi_tpu_torch.decoder.training_graph import TrainingGraphCompiler
    compiler = TrainingGraphCompiler(lang, model.tm)
    utts = sorted(feats)
    dense = pack_training_graphs([compiler.compile_text(text[u])
                                  for u in utts])
    aligner = DenseAligner(model.tm.tid_to_pdf_array, device=device)
    return realign(model.am, aligner, dict(zip(utts, dense)), utts, feats)


# Copied from kaldi_tpu/pipelines/chain_recipe.py default_xconfig.
def default_xconfig(feat_dim: int, num_pdfs: int, hidden: int) -> str:
    """The recipe's model written in the xconfig language (the
    reference recipes define their chain models as xconfig text that
    steps/nnet3/xconfig_to_configs.py expands; here am/xconfig.py
    interprets it directly as the model)."""
    bn = max(hidden // 4, 1)
    return f"""
input name=input dim={feat_dim}
relu-batchnorm-layer name=tdnn1 input=Append(-1,0,1) dim={hidden}
tdnnf-layer name=tdnnf2 dim={hidden} bottleneck-dim={bn} time-stride=1
tdnnf-layer name=tdnnf3 dim={hidden} bottleneck-dim={bn} time-stride=1
tdnnf-layer name=tdnnf4 dim={hidden} bottleneck-dim={bn} time-stride=3
tdnnf-layer name=tdnnf5 dim={hidden} bottleneck-dim={bn} time-stride=3
relu-batchnorm-layer name=prefinal-chain dim={hidden}
output-layer name=output dim={num_pdfs} include-log-softmax=false
"""


def run(num_utts: int = 50, num_test: int = 12, num_epochs: int = 40,
        hidden: int = 128, seed: int = 1, xconfig: str = None,
        device: torch.device | str = "cuda"):
    """``xconfig``: xconfig text, ``"default"`` (``default_xconfig``) or
    None (the built-in TDNN-F)."""
    device = resolve_device(device)
    timer = Timer()
    lex = mini_lexicon()
    lang = Lang(lex)
    train = make_synthetic_dataset(lex, num_utts=num_utts, max_words=5,
                                   seed=seed)
    test = make_synthetic_dataset(lex, num_utts=num_test, max_words=5,
                                  seed=seed + 50)
    base_tr = base_feats(train, device=device)
    base_te = base_feats(test, device=device)
    delta_tr = _on_device(base_tr, add_deltas, device)
    log.info("stage 0: data + features (%.0fs)", timer.elapsed())

    # GMM system for alignments
    gmm = train_mono(delta_tr, train.text, lang, MonoTrainConfig(
        num_iters=10, totgauss=200, realign_iters=(1, 2, 3, 4, 5, 6, 8)),
        device=device)
    ali = gmm_alignments(gmm, delta_tr, train.text, lang, device)
    log.info("stage 1: GMM + alignments (%.0fs)", timer.elapsed())

    # chain topology / tree / denominator graph
    phones = lang.phone_list()
    chain_topo = HmmTopology.chain(phones)
    chain_tree = MonophoneContextDependency(phones, chain_topo)
    phone_seqs = [gmm.tm.alignment_to_phones(ali[u]) for u in sorted(ali)]
    den = make_denominator_graph(phone_seqs, chain_tree, chain_topo,
                                 order=3)
    log.info("stage 2: den graph %d states %d arcs", den.num_states,
             len(den.src))

    # egs from phone-duration runs
    runs = {u: phone_alignment_runs(gmm.tm, ali[u]) for u in ali}
    feat_dim = next(iter(delta_tr.values())).shape[1]
    egs = make_chain_egs(delta_tr, runs, chain_tree, chain_topo,
                         chunk_size=51, subsample=3, den=den)
    log.info("stage 3: %d egs chunks of %d frames", egs.feats.shape[0],
             egs.feats.shape[1])

    if xconfig is not None:
        from kaldi_tpu_torch.am.xconfig import chain_model_from_xconfig
        if xconfig == "default":
            xconfig = default_xconfig(feat_dim, chain_tree.num_pdfs, hidden)
        cfg = chain_model_from_xconfig(xconfig, frame_subsampling_factor=3)
    else:
        cfg = TdnnConfig(feat_dim=feat_dim, num_pdfs=chain_tree.num_pdfs,
                         hidden_dim=hidden, bottleneck_dim=hidden // 4,
                         num_layers=5, frame_subsampling_factor=3)
    trainer = ChainTrainer(cfg, den, ChainTrainConfig(
        num_epochs=num_epochs, batch_size=16, learning_rate=2e-3),
        device=device)
    final = trainer.train(egs, log_every=50)
    log.info("stage 4: chain training done, objf %.3f (%.0fs)",
             final["objf"], timer.elapsed())

    # decode: chain graph (self-loop-scale 1.0) at the subsampled rate
    tm_chain = TransitionModel(chain_topo, chain_tree)
    G = arpa_to_fst(ArpaModel.parse(make_unigram_arpa(
        {w: 1.0 for w, _ in lex.entries})), lang.words)
    HCLG = mkgraph(lang, tm_chain, G, self_loop_scale=1.0)
    dec = DenseDecoder(HCLG, tm_chain.tid_to_pdf_array,
                       DenseDecoderConfig(beam=16.0, acoustic_scale=1.0),
                       device=device)
    scorer = trainer.scores_fn()
    delta_te = _on_device(base_te, add_deltas, device)
    hyps = {}
    for u in sorted(base_te):
        scores = scorer(delta_te[u][None])[0]                # (T/3, P)
        tids, ols, cost = dec.decode(scores)
        hyps[u] = [lang.words.find(o) for o in ols]
    wer = compute_wer(test.text, hyps)
    log.info("stage 5: chain decode %s (%.0fs total)", wer,
             timer.elapsed())
    print(wer)
    return wer


def main(argv=None):
    po = ParseOptions(
        "Usage: python -m kaldi_tpu_torch.pipelines.chain_recipe")
    po.register("num-utts", int, 50, "training utterances")
    po.register("num-epochs", int, 40, "training epochs")
    po.register("xconfig", str, "",
                "xconfig file defining the model ('default' = the "
                "built-in TDNN-F xconfig)")
    po.register("device", str, "cuda", "torch device to run on")
    po.read(argv)
    xc = po["xconfig"] or None
    if xc and xc != "default":
        with open(xc) as f:
            xc = f.read()
    wer = run(num_utts=po["num-utts"], num_epochs=po["num-epochs"],
              xconfig=xc, device=po["device"])
    return 0 if wer.wer < 20.0 else 1


if __name__ == "__main__":
    sys.exit(main())
