"""Triphone GMM training: tri1 (deltas), tri2b (LDA+MLLT), tri3b (SAT).

Port of kaldi_tpu/pipelines/tri.py (parity targets
steps/train_deltas.sh, steps/train_lda_mllt.sh, steps/train_sat.sh and
their binaries: acc-tree-stats, cluster-phones, compile-questions,
build-tree, gmm-init-model, convert-ali, gmm-est-fmllr).  The tree
statistics, questions, tree, alignment conversion and the LDA, MLLT
and fMLLR estimators are the original's host numpy, copied; the models
live on ``device``, where each realignment computes every utterance's
log-likelihoods in one GMM kernel launch and aligns the batch at once
(pipelines/mono.py ``realign``), and the accumulators and mixture
posteriors run.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from kaldi_tpu_torch.core.logging import get_logger
from kaldi_tpu_torch.am.gmm import (AmDiagGmm, GmmAccs,
                                    accumulate_stats_twofeats, mixup,
                                    mle_update)
from kaldi_tpu_torch.am.topology import HmmTopology
from kaldi_tpu_torch.am.transitions import TransitionModel
from kaldi_tpu_torch.am.transforms import (FmllrAccs, LdaEstimate, MlltAccs,
                                           accumulate_fmllr_for_utt,
                                           accumulate_fmllr_from_post)
from kaldi_tpu_torch.am.tree import (GaussStats, TreeContextDependency,
                                     build_tree)
from kaldi_tpu_torch.decoder.align import DenseAligner, pack_training_graphs
from kaldi_tpu_torch.decoder.training_graph import TrainingGraphCompiler
from kaldi_tpu_torch.fst.lang import Lang
from kaldi_tpu_torch.pipelines.mono import (IterationReport, MonoModel,
                                            accumulate_all, realign)

log = get_logger(__name__)


# ---------------------------------------------------------------------------
# Tree statistics (acc-tree-stats) and questions (cluster-phones)
# ---------------------------------------------------------------------------

def _frame_info(tm: TransitionModel, tids: Sequence[int]
                ) -> List[Tuple[int, int, int]]:
    """Per frame: (phone_index_in_seq, phone, hmm_state)."""
    out = []
    idx = -1
    for tid in tids:
        phone = tm.transition_id_to_phone(tid)
        hmm_state = tm.transition_id_to_hmm_state(tid)
        is_initial = (hmm_state == 0 and not tm.is_self_loop(tid))
        if is_initial or idx < 0:
            idx += 1
        out.append((idx, phone, hmm_state))
    return out


def accumulate_tree_stats(feats: Dict[str, np.ndarray],
                          alignments: Dict[str, Sequence[int]],
                          tm: TransitionModel,
                          context_width: int = 3,
                          central_position: int = 1
                          ) -> Dict[Tuple[Tuple[int, ...], int], GaussStats]:
    stats: Dict[Tuple[Tuple[int, ...], int], GaussStats] = {}
    for u, tids in alignments.items():
        f = np.asarray(feats[u], dtype=np.float64)
        info = _frame_info(tm, tids)
        phones = []
        for i, (pi, ph, st) in enumerate(info):
            if pi == len(phones):
                phones.append(ph)
        for t, (pi, ph, hmm_state) in enumerate(info):
            window = []
            for off in range(-central_position,
                             context_width - central_position):
                j = pi + off
                window.append(phones[j] if 0 <= j < len(phones) else 0)
            entry = tm.topo.topology_for_phone(ph)
            pdf_class = entry[hmm_state].forward_pdf_class
            key = (tuple(window), pdf_class)
            if key not in stats:
                stats[key] = GaussStats(f.shape[1])
            stats[key].accumulate(f[t])
    return stats


def cluster_phone_questions(stats, central_position: int = 1
                            ) -> List[frozenset]:
    """Agglomerative clustering of phones by their pooled Gaussian stats
    (cluster-phones + compile-questions): every intermediate merge set
    becomes a question; singletons included."""
    per_phone: Dict[int, GaussStats] = {}
    for (window, pc), st in stats.items():
        ph = window[central_position]
        if ph not in per_phone:
            per_phone[ph] = GaussStats(len(st.sum))
        per_phone[ph].add(st)
    phones = sorted(per_phone)
    clusters: List[Tuple[frozenset, GaussStats]] = [
        (frozenset([p]), per_phone[p]) for p in phones]
    questions = [c for c, _ in clusters]
    while len(clusters) > 1:
        best = None
        for i in range(len(clusters)):
            for j in range(i + 1, len(clusters)):
                merged = GaussStats(len(clusters[i][1].sum))
                merged.add(clusters[i][1])
                merged.add(clusters[j][1])
                loss = (clusters[i][1].objf() + clusters[j][1].objf()
                        - merged.objf())
                if best is None or loss < best[0]:
                    best = (loss, i, j, merged)
        _, i, j, merged = best
        newset = clusters[i][0] | clusters[j][0]
        clusters = [c for k, c in enumerate(clusters) if k not in (i, j)]
        clusters.append((newset, merged))
        questions.append(newset)
    return questions


def init_model_from_tree_stats(tree: TreeContextDependency, stats,
                               var_floor: float = 1e-3,
                               device: torch.device | str = "cuda"
                               ) -> AmDiagGmm:
    """gmm-init-model: leaf pdf = single Gaussian from its tree stats."""
    dim = len(next(iter(stats.values())).sum)
    pooled: List[GaussStats] = [GaussStats(dim) for _ in range(tree.num_pdfs)]
    glob = GaussStats(dim)
    for (window, pc), st in stats.items():
        pdf = tree.compute(window, pc)
        pooled[pdf].add(st)
        glob.add(st)
    gmean = glob.sum / max(glob.count, 1)
    gvar = np.maximum(glob.sumsq / max(glob.count, 1) - gmean ** 2, var_floor)
    means = np.zeros((tree.num_pdfs, 1, dim))
    variances = np.zeros((tree.num_pdfs, 1, dim))
    for p, st in enumerate(pooled):
        if st.count > 2:
            m = st.sum / st.count
            v = np.maximum(st.sumsq / st.count - m ** 2, var_floor)
        else:
            m, v = gmean, gvar
        means[p, 0] = m
        variances[p, 0] = v
    return AmDiagGmm(np.ones((tree.num_pdfs, 1)), means, variances,
                     device=device)


def convert_alignment(tm_old: TransitionModel, tm_new: TransitionModel,
                      tids: Sequence[int], context_width: int = 3,
                      central_position: int = 1) -> List[int]:
    """convert-ali: remap a tid alignment onto a new tree (same topology
    → same hmm-state path; only pdfs change)."""
    info = _frame_info(tm_old, tids)
    phones: List[int] = []
    for pi, ph, st in info:
        if pi == len(phones):
            phones.append(ph)
    out: List[int] = []
    tree = tm_new.tree
    for t, tid in enumerate(tids):
        pi, ph, hmm_state = info[t]
        window = []
        for off in range(-central_position, context_width - central_position):
            j = pi + off
            window.append(phones[j] if 0 <= j < len(phones) else 0)
        entry = tm_new.topo.topology_for_phone(ph)
        st = entry[hmm_state]
        fwd = tree.compute(window, st.forward_pdf_class)
        slf = tree.compute(window, st.self_loop_pdf_class)
        ts = tm_new.tuple_to_transition_state(ph, hmm_state, fwd, slf)
        out.append(tm_new.pair_to_transition_id(ts, tm_old.id2index[tid]))
    return out


# ---------------------------------------------------------------------------
# Triphone training
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TriTrainConfig:
    num_iters: int = 20
    max_iter_inc: int = 12
    totgauss: int = 1000
    num_leaves: int = 100
    realign_iters: Sequence[int] = (1, 2, 4, 6, 8, 10, 12, 15, 18)
    self_loop_scale: float = 0.1
    transition_scale: float = 1.0
    context_width: int = 3
    central_position: int = 1
    # LDA+MLLT options
    splice_left: int = 3
    splice_right: int = 3
    lda_dim: int = 30
    mllt_iters: Sequence[int] = (2, 4, 6, 12)
    # SAT options
    fmllr_iters: Sequence[int] = (2, 4, 6, 12)
    fmllr_min_count: float = 100.0


@dataclasses.dataclass
class TriModel:
    am: AmDiagGmm
    tm: TransitionModel
    lang: Lang
    tree: TreeContextDependency
    lda_mat: Optional[np.ndarray] = None          # (lda_dim, spliced+1)
    fmllr: Optional[Dict[str, np.ndarray]] = None  # speaker → (D, D+1)


def train_tri(feats: Dict[str, np.ndarray], text: Dict[str, List[str]],
              lang: Lang, prev: MonoModel | "TriModel",
              prev_ali: Dict[str, List[int]],
              config: TriTrainConfig = None,
              device: torch.device | str = "cuda",
              report: Optional[IterationReport] = None
              ) -> Tuple["TriModel", Dict[str, List[int]]]:
    """train_deltas-equivalent: build a triphone tree from previous
    alignments, init, train with periodic realignment.  `feats` are the
    final features (deltas or LDA applied by the caller), on the host;
    the model lives on ``device``.  ``report`` as in train_mono."""
    cfg = config or TriTrainConfig()
    utts = sorted(feats)

    stats = accumulate_tree_stats(feats, prev_ali, prev.tm,
                                  cfg.context_width, cfg.central_position)
    questions = cluster_phone_questions(stats, cfg.central_position)
    tree = build_tree(stats, questions, cfg.context_width,
                      cfg.central_position, cfg.num_leaves)
    topo = HmmTopology.three_state(lang.phone_list())
    tm = TransitionModel(topo, tree)
    am = init_model_from_tree_stats(tree, stats, device=device)

    ali = {u: convert_alignment(prev.tm, tm, prev_ali[u],
                                cfg.context_width, cfg.central_position)
           for u in utts}

    compiler = TrainingGraphCompiler(lang, tm, cfg.transition_scale,
                                     cfg.self_loop_scale)
    dense = dict(zip(utts, pack_training_graphs(
        [compiler.compile_text(text[u]) for u in utts])))
    aligner = DenseAligner(tm.tid_to_pdf_array, acoustic_scale=1.0,
                           device=device)

    gauss_inc = max(0, cfg.totgauss - am.num_gauss()) // max(cfg.max_iter_inc,
                                                             1)
    for it in range(cfg.num_iters):
        if it in cfg.realign_iters and it > 0:
            ali = realign(am, aligner, dense, utts, feats)
        accs, tid_counts = accumulate_all(am, tm, utts, feats, ali)
        if report is not None:
            report(it, ali, accs)
        mle_update(am, accs)
        tm.mle_update(tid_counts)
        if it < cfg.max_iter_inc and am.num_gauss() < cfg.totgauss:
            am = mixup(am, am.num_gauss() + gauss_inc, seed=it)
        log.info("train_tri iter %d: %d gauss, loglike/frame %.3f", it,
                 am.num_gauss(), accs.tot_like / max(accs.tot_frames, 1))
    return TriModel(am, tm, lang, tree), ali


def estimate_lda(feats_spliced: Dict[str, np.ndarray],
                 ali: Dict[str, List[int]], tm: TransitionModel,
                 lda_dim: int) -> np.ndarray:
    """LDA over spliced features with pdf classes (steps/train_lda_mllt.sh
    lda-acc stage)."""
    dim = next(iter(feats_spliced.values())).shape[1]
    est = LdaEstimate(tm.num_pdfs, dim)
    for u, tids in ali.items():
        pdfs = tm.tid_to_pdf_array[np.asarray(tids)]
        est.accumulate_batch(np.asarray(feats_spliced[u], np.float64), pdfs)
    return est.estimate(lda_dim)


def estimate_mllt(am: AmDiagGmm, feats: Dict[str, np.ndarray],
                  ali: Dict[str, List[int]], tm: TransitionModel
                  ) -> Tuple[np.ndarray, float]:
    accs = MlltAccs(am.dim)
    for u, tids in ali.items():
        pdf_ali = tm.tid_to_pdf_array[np.asarray(tids)]
        post = am.component_posteriors(
            np.asarray(feats[u], np.float32), pdf_ali).cpu().numpy()
        accs.accumulate(post, np.asarray(feats[u]),
                        am.means[pdf_ali], 1.0 / am.vars[pdf_ali])
    return accs.update()


def apply_mllt_to_model(am: AmDiagGmm, M: np.ndarray) -> None:
    """Transform GMM means by M (gmm-transform-means)."""
    am.means = am.means @ M.T
    am.refresh()


def estimate_alignment_model(am_sat: AmDiagGmm, tm: TransitionModel,
                             feats_adapted: Dict[str, np.ndarray],
                             feats_raw: Dict[str, np.ndarray],
                             ali: Dict[str, List[int]]) -> AmDiagGmm:
    """The SAT 'alimdl' (train_sat.sh final stage): re-estimate the
    Gaussians with posteriors from the SAT model on ADAPTED features
    but stats on UNADAPTED features (gmm-acc-stats-twofeats + gmm-est).
    The first, transform-less decoding pass must use this model — the
    SAT model is mismatched to unadapted features and its first-pass
    errors corrupt the fMLLR estimate."""
    accs = GmmAccs.zeros(am_sat.num_pdfs, am_sat.max_mix, am_sat.dim)
    for u, tids in ali.items():
        pdf_ali = tm.tid_to_pdf_array[np.asarray(tids)]
        accumulate_stats_twofeats(am_sat,
                                  np.asarray(feats_adapted[u],
                                             np.float32),
                                  np.asarray(feats_raw[u], np.float32),
                                  pdf_ali, accs)
    am_ali = AmDiagGmm(am_sat.weights, am_sat.means, am_sat.vars,
                       device=am_sat.device)
    mle_update(am_ali, accs, remove_low_count=False)
    return am_ali


def estimate_fmllr_per_speaker_post(am: AmDiagGmm,
                                    feats: Dict[str, np.ndarray],
                                    posts: Dict[str, list],
                                    tm: TransitionModel,
                                    utt2spk: Dict[str, str],
                                    silence_phones=(),
                                    silence_weight: float = 0.01,
                                    min_count: float = 100.0
                                    ) -> Dict[str, np.ndarray]:
    """Per-speaker fMLLR from LATTICE posteriors (the decode_fmllr.sh
    contract: lattice-to-post | weight-silence-post | gmm-est-fmllr).
    posts maps utt → per-frame [(tid, weight), ...]; silence-phone
    posteriors are down-weighted so first-pass errors on silence
    frames don't corrupt the transform the way a hard 1-best
    alignment does."""
    sil = set(silence_phones)
    accs: Dict[str, FmllrAccs] = {}
    for u, frames in posts.items():
        spk = utt2spk[u]
        if spk not in accs:
            accs[spk] = FmllrAccs(am.dim)
        pdf_frames = []
        for items in frames:
            row = []
            for tid, w in items:
                if tm.transition_id_to_phone(tid) in sil:
                    w *= silence_weight
                row.append((tm.transition_id_to_pdf(tid), w))
            pdf_frames.append(row)
        accumulate_fmllr_from_post(accs[spk], am,
                                   np.asarray(feats[u], np.float32),
                                   pdf_frames)
    return {spk: a.update(min_count=min_count)[0]
            for spk, a in accs.items()}


def estimate_fmllr_per_speaker(am: AmDiagGmm, feats: Dict[str, np.ndarray],
                               ali: Dict[str, List[int]],
                               tm: TransitionModel,
                               utt2spk: Dict[str, str],
                               min_count: float = 100.0
                               ) -> Dict[str, np.ndarray]:
    accs: Dict[str, FmllrAccs] = {}
    for u, tids in ali.items():
        spk = utt2spk[u]
        if spk not in accs:
            accs[spk] = FmllrAccs(am.dim)
        pdf_ali = tm.tid_to_pdf_array[np.asarray(tids)]
        accumulate_fmllr_for_utt(accs[spk], am,
                                 np.asarray(feats[u], np.float32), pdf_ali)
    return {spk: a.update(min_count=min_count)[0] for spk, a in accs.items()}
