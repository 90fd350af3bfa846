"""Monophone GMM-HMM training.

Port of kaldi_tpu/pipelines/mono.py (parity target
egs/wsj/s5/steps/train_mono.sh driving gmm-init-mono,
compile-train-graphs, align-equal-compiled, gmm-acc-stats-ali, gmm-est,
gmm-align-compiled).  Each iteration's device work is two batched
steps on the model's device: the GMM log-likelihoods of every
utterance in one GMM kernel launch over the concatenated frames, split
by length (the original makes one call per utterance; the function is
the same), then the dense Viterbi alignment of the whole batch; and
the statistics' accumulation over all frames at once.  The MLE updates
run on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from kaldi_tpu_torch.am.gmm import (
    AmDiagGmm,
    GmmAccs,
    accumulate_stats,
    global_stats,
    mixup,
    mle_update,
)
from kaldi_tpu_torch.am.topology import HmmTopology
from kaldi_tpu_torch.am.transitions import TransitionModel
from kaldi_tpu_torch.am.tree import MonophoneContextDependency
from kaldi_tpu_torch.core.logging import get_logger
from kaldi_tpu_torch.decoder.align import DenseAligner, pack_training_graphs
from kaldi_tpu_torch.decoder.training_graph import (TrainingGraphCompiler,
                                                    equal_align)
from kaldi_tpu_torch.fst.lang import Lang

log = get_logger(__name__)

# called after each iteration's accumulation as report(iteration,
# alignments utt → tids, accumulators)
IterationReport = Callable[[int, Dict[str, List[int]], GmmAccs], None]


# Copied from kaldi_tpu/pipelines/mono.py MonoTrainConfig.
@dataclasses.dataclass
class MonoTrainConfig:
    num_iters: int = 20
    max_iter_inc: int = 12          # iterations over which #gauss grows
    totgauss: int = 300
    realign_iters: Sequence[int] = tuple(
        [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 14, 16, 18])
    self_loop_scale: float = 0.1
    transition_scale: float = 1.0
    acoustic_scale: float = 1.0     # alignment uses scale 1 like the ref
    beam: float = 1e9               # dense aligner is exact anyway
    perturb_factor: float = 0.01


# Copied from kaldi_tpu/pipelines/mono.py MonoModel.
@dataclasses.dataclass
class MonoModel:
    am: AmDiagGmm
    tm: TransitionModel
    lang: Lang


def realign(am: AmDiagGmm, aligner: DenseAligner, dense, utts,
            feats: Dict[str, np.ndarray]) -> Dict[str, List[int]]:
    """Every utterance's log-likelihoods in one GMM launch over the
    concatenated frames, split by length, then one aligned batch."""
    lls = am.loglikes(np.concatenate([feats[u] for u in utts]))
    lls = torch.split(lls, [feats[u].shape[0] for u in utts])
    return {u: tids for u, (tids, _) in
            zip(utts, aligner.align_batch([dense[u] for u in utts], lls))}


def accumulate_all(am: AmDiagGmm, tm: TransitionModel, utts,
                   feats: Dict[str, np.ndarray], ali: Dict[str, List[int]]):
    """All utterances concatenated into one device accumulation →
    (GmmAccs, transition-id counts)."""
    accs = GmmAccs.zeros(am.num_pdfs, am.max_mix, am.dim)
    all_feats = np.concatenate([feats[u] for u in utts])
    all_tids = np.concatenate([np.asarray(ali[u]) for u in utts])
    accumulate_stats(am, all_feats, tm.tid_to_pdf_array[all_tids], accs)
    tid_counts = np.bincount(all_tids, minlength=tm.num_transition_ids + 1
                             ).astype(np.float64)
    return accs, tid_counts


def train_mono(feats: Dict[str, np.ndarray], text: Dict[str, List[str]],
               lang: Lang, config: MonoTrainConfig = None,
               device: torch.device | str = "cuda",
               report: Optional[IterationReport] = None) -> MonoModel:
    """feats: utt → (T, D) feature matrix (already CMVN'd etc.), on the
    host; the model and the aligner live on ``device``."""
    cfg = config or MonoTrainConfig()
    phones = lang.phone_list()
    topo = HmmTopology.three_state(phones)
    tree = MonophoneContextDependency(phones, topo)
    tm = TransitionModel(topo, tree)
    utts = sorted(feats)

    # flat start (gmm-init-mono)
    gmean, gvar = global_stats(feats[u] for u in utts)
    am = AmDiagGmm.flat_start(tree.num_pdfs, gmean, gvar,
                              perturb=cfg.perturb_factor, device=device)

    # training graphs (compile-train-graphs)
    compiler = TrainingGraphCompiler(lang, tm, cfg.transition_scale,
                                     cfg.self_loop_scale)
    graphs = {u: compiler.compile_text(text[u]) for u in utts}
    dense = dict(zip(utts, pack_training_graphs([graphs[u] for u in utts])))

    # equal alignment (align-equal-compiled)
    ali: Dict[str, List[int]] = {}
    for u in utts:
        ali[u] = equal_align(graphs[u], feats[u].shape[0])

    aligner = DenseAligner(tm.tid_to_pdf_array,
                           acoustic_scale=cfg.acoustic_scale, device=device)

    gauss_inc = max(0, (cfg.totgauss - am.num_gauss())) // max(
        cfg.max_iter_inc, 1)

    for it in range(cfg.num_iters):
        if it in cfg.realign_iters and it > 0:
            ali = realign(am, aligner, dense, utts, feats)
        accs, tid_counts = accumulate_all(am, tm, utts, feats, ali)
        if report is not None:
            report(it, ali, accs)
        mle_update(am, accs)
        tm.mle_update(tid_counts)
        if it < cfg.max_iter_inc and am.num_gauss() < cfg.totgauss:
            am = mixup(am, am.num_gauss() + gauss_inc,
                       perturb=cfg.perturb_factor, seed=it)
        log.info("train_mono iter %d: %d gauss, avg loglike/frame %.3f",
                 it, am.num_gauss(),
                 accs.tot_like / max(accs.tot_frames, 1))
    return MonoModel(am, tm, lang)
