"""Seeded audio and acoustic models for smoke runs and profiles.

The GMMs here stand in for trained ones at a published width.  Their
parameters are drawn from a seed, with mixture counts as uneven as
mix-up leaves them, so that the padded slots of the GMM kernel's layout
are exercised.  ``synth_speech`` renders a frame-level pdf alignment as
a waveform in which each pdf has its own spectrum, and ``aligned_gmm``
draws a GMM around the features of each pdf's frames: a decode of that
audio then behaves like a trained model's on real speech (a dominant
best path, small lattices), which a GMM drawn around global statistics
does not.  ``align_workload`` gives the forced aligner a batch of
training graphs and log-likelihoods peaked along a path of each.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from kaldi_tpu_torch.am.gmm import AmDiagGmm


def mix_counts(rng: np.random.Generator, num_pdfs: int, total: int,
               lo: int, hi: int) -> np.ndarray:
    """Seeded Gaussians per pdf, each in [lo, hi], summing to ``total``:
    uneven, as mix-up leaves them."""
    counts = np.full(num_pdfs, lo)
    appetite = rng.gamma(0.7, size=num_pdfs)
    extra = total - lo * num_pdfs
    while extra > 0:
        w = appetite * (counts < hi)
        add = np.minimum(rng.multinomial(extra, w / w.sum()), hi - counts)
        counts += add
        extra -= int(add.sum())
    return counts


def seeded_gmm(rng: np.random.Generator, counts: np.ndarray,
               mean: np.ndarray, var: np.ndarray,
               spread: float, device="cuda") -> AmDiagGmm:
    """An AmDiagGmm with counts[p] live slots for pdf p, padded to the
    largest count with zero-weight slots.  ``mean`` and ``var`` are (D,)
    or per pdf (P, D): slot means are drawn ``spread`` standard
    deviations around the mean, variances 0.5–1.5 times ``var``; the
    model is bound to ``device``."""
    P, M, D = len(counts), int(counts.max()), np.shape(mean)[-1]
    mean = np.broadcast_to(mean, (P, D))[:, None, :]
    var = np.broadcast_to(var, (P, D))[:, None, :]
    live = np.arange(M)[None, :] < counts[:, None]
    w = np.where(live, rng.uniform(0.5, 1.5, (P, M)), 0.0)
    w /= w.sum(axis=1, keepdims=True)
    means = mean + spread * np.sqrt(var) * rng.standard_normal((P, M, D))
    variances = var * rng.uniform(0.5, 1.5, (P, M, D))
    return AmDiagGmm(w, means, variances, device=device)


def tri3b_gmm(rng: np.random.Generator, num_pdfs: int = 2500,
              num_gauss: int = 15000, dim: int = 40,
              device="cuda") -> AmDiagGmm:
    """A GMM at the mini_librispeech tri3b width (egs/mini_librispeech/
    s5/run.sh: steps/train_sat.sh 2500 15000, on 40 LDA+MLLT dims): 2–10
    Gaussians per pdf, for features of zero mean and unit variance."""
    return seeded_gmm(rng, mix_counts(rng, num_pdfs, num_gauss, 2, 10),
                      np.zeros(dim), np.ones(dim), spread=3.0,
                      device=device)


def pdf_signatures(rng: np.random.Generator, num_pdfs: int,
                   silent: Sequence[int], partials: int = 4):
    """Each pdf's spectrum: ``partials`` sinusoids at seeded frequencies
    (100–4000 Hz) and amplitudes; the ``silent`` pdfs have none."""
    freqs = rng.uniform(100.0, 4000.0, (num_pdfs, partials))
    amps = rng.uniform(300.0, 3000.0, (num_pdfs, partials))
    amps[list(silent)] = 0.0
    return freqs, amps


def synth_speech(pdfs: Sequence[int], freqs: np.ndarray, amps: np.ndarray,
                 rng: np.random.Generator, samp_freq: float = 16000.0,
                 window: int = 400, shift: int = 160,
                 noise: float = 100.0) -> np.ndarray:
    """A waveform whose feature frames (``window`` samples every
    ``shift``, snip-edges) are centred on their pdf's segment, one frame
    per entry of ``pdfs``: phase-continuous sinusoids at the pdf's
    frequencies over white noise, at int16 amplitude."""
    T = len(pdfs)
    n = shift * T + window - shift
    seg = np.clip((np.arange(n) - (window - shift) // 2) // shift, 0, T - 1)
    which = np.asarray(pdfs)[seg]
    phase = 2.0 * np.pi * np.cumsum(freqs[which] / samp_freq, axis=0)
    x = (amps[which] * np.sin(phase)).sum(axis=1)
    x += noise * rng.standard_normal(n)
    return np.clip(x, -32768, 32767).astype(np.float32)


def aligned_gmm(rng: np.random.Generator, feats: Sequence[np.ndarray],
                aligns: Sequence[Sequence[int]],
                counts: np.ndarray, device="cuda") -> AmDiagGmm:
    """A GMM drawn around the features of each pdf's frames (half a
    standard deviation of spread); a pdf with fewer than 2 frames gets
    the global statistics.  Variances are floored at a hundredth of
    the global variance."""
    X = np.concatenate([np.asarray(f, np.float64) for f in feats])
    A = np.concatenate([np.asarray(a) for a in aligns])
    gmean, gvar = X.mean(axis=0), X.var(axis=0)
    P = len(counts)
    mean = np.tile(gmean, (P, 1))
    var = np.tile(gvar, (P, 1))
    for p in range(P):
        sel = X[A == p]
        if len(sel) >= 2:
            mean[p] = sel.mean(axis=0)
            var[p] = np.maximum(sel.var(axis=0), 0.01 * gvar)
    return seeded_gmm(rng, counts, mean, var, spread=0.5, device=device)


def model_frames(am: AmDiagGmm, rng: np.random.Generator, T: int):
    """T frames drawn from the model: a seeded pdf alignment, each frame
    from one of its pdf's Gaussians chosen by weight.  → (frames (T, D)
    float32, pdfs (T,) int64)."""
    pdfs = rng.integers(0, am.num_pdfs, T)
    cum = np.cumsum(am.weights[pdfs], axis=1)
    comp = np.minimum((cum < rng.random((T, 1)) * cum[:, -1:]).sum(1),
                      am.max_mix - 1)
    x = am.means[pdfs, comp] + np.sqrt(am.vars[pdfs, comp]) \
        * rng.standard_normal((T, am.dim))
    return x.astype(np.float32), pdfs


def align_workload(task, n_utts: int, seed: int):
    """A batch for the forced aligner: ``n_utts`` seeded sentences of a
    large-vocabulary task (pipelines/largevocab.py), their training
    graphs under a three-state monophone model of the task's lexicon,
    and (T, P) float32 log-likelihoods peaked (by 6) on the pdfs of an
    equal alignment 1.5–3× the sentence's fewest frames long, with unit
    Gaussian noise.  → (packed graphs (decoder/align.py DenseRGraph),
    log-likelihoods, transition model)."""
    from kaldi_tpu_torch.am.topology import HmmTopology
    from kaldi_tpu_torch.am.transitions import TransitionModel
    from kaldi_tpu_torch.am.tree import MonophoneContextDependency
    from kaldi_tpu_torch.decoder.align import pack_training_graphs
    from kaldi_tpu_torch.decoder.training_graph import (TrainingGraphCompiler,
                                                        equal_align)
    from kaldi_tpu_torch.fst.lang import Lang, Lexicon
    from kaldi_tpu_torch.pipelines.largevocab import sample_eval_set
    rng = np.random.default_rng(seed)
    lang = Lang(Lexicon(sorted(task.pron_of.items())))
    phones = lang.phone_list()
    topo = HmmTopology.three_state(phones)
    tm = TransitionModel(topo, MonophoneContextDependency(phones, topo))
    compiler = TrainingGraphCompiler(lang, tm)
    sents = sample_eval_set(task, n_utts, max_words=12, seed=seed)
    graphs, lls = [], []
    for u in sorted(sents):
        g = compiler.compile_text(sents[u])
        fewest = 3 * sum(len(task.pron_of[w]) for w in sents[u])
        T = int(fewest * rng.uniform(1.5, 3.0))
        pdfs = tm.tid_to_pdf_array[np.asarray(equal_align(g, T))]
        ll = rng.standard_normal((T, tm.num_pdfs)).astype(np.float32) - 6.0
        ll[np.arange(T), pdfs] += 6.0
        graphs.append(g)
        lls.append(ll)
    return pack_training_graphs(graphs), lls, tm
