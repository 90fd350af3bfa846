"""Diagonal-covariance GMM acoustic model: inference and training.

Port of kaldi_tpu/am/gmm.py (parity targets src/gmm/diag-gmm.h,
am-diag-gmm.h, mle-diag-gmm.h, and the flat start and mixing up of
gmm-init-mono / gmm-mixup).  The whole model is three dense
tensors padded to a common number of mixture slots,

    gconsts        (P, M)     log w − ½(D·log2π + Σ log σ² + Σ μ²/σ²)
    means_invvars  (P, M, D)  μ/σ²
    inv_vars       (P, M, D)  1/σ²

and per-utterance log-likelihoods for all pdfs are
``logsumexp_m(gconst + x·(μ/σ²) − ½x²·(1/σ²))``: the GMM kernel
(ops/gmm.py ``CudaGmm``, csrc/gmm.cu) on a CUDA device, its plain
version on the CPU.  Unused slots carry gconst = −1e30.

The parameters stay float64 numpy on the host, exactly as in the
original, so ``AmDiagGmm(jam.weights, jam.means, jam.vars)`` carries a
JAX-side model across.

Training: ``component_posteriors`` and ``accumulate_stats`` are tensor
ops on the model's device (the aligned pdfs' parameters gathered per
frame, two batched products and a softmax over the mixture slots, sums
by pdf for the occupancies and first and second moments in an order
that does not change from run to run, all in float32), and the sums go into ``GmmAccs`` as float64 on the host, as
in the original.  Frames are not padded to 64-frame buckets (those only
served XLA's compile cache).  ``flat_start``, ``GmmAccs``,
``mle_update``, ``map_update``, ``mixup`` and ``global_stats`` are
numpy copies.  Every update ends in ``refresh()``, and ``mixup``
returns a new model: the device tables never go stale.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Tuple

import numpy as np
import torch

from kaldi_tpu_torch.core.logging import get_logger
from kaldi_tpu_torch.device import resolve_device
from kaldi_tpu_torch.ops.gmm import NEG, CudaGmm

log = get_logger(__name__)

_LOG_2PI = math.log(2.0 * math.pi)


class AmDiagGmm:
    """All pdfs' GMMs as padded (P, M, D) arrays (float64 host copy)
    bound to one device, where ``loglikes`` runs."""

    def __init__(self, weights: np.ndarray, means: np.ndarray,
                 variances: np.ndarray, device: torch.device | str = "cuda"):
        """weights (P, M) with zero rows padding; means/vars (P, M, D)."""
        self.weights = weights.astype(np.float64)
        self.means = means.astype(np.float64)
        self.vars = variances.astype(np.float64)
        self.device = resolve_device(device)
        self._kernel = None

    @property
    def num_pdfs(self) -> int:
        return self.weights.shape[0]

    @property
    def max_mix(self) -> int:
        return self.weights.shape[1]

    @property
    def dim(self) -> int:
        return self.means.shape[2]

    def num_gauss(self) -> int:
        return int((self.weights > 0).sum())

    # Copied from kaldi_tpu/am/gmm.py AmDiagGmm.flat_start (+ device).
    @staticmethod
    def flat_start(num_pdfs: int, glob_mean: np.ndarray, glob_var: np.ndarray,
                   perturb: float = 0.0, seed: int = 0,
                   device: torch.device | str = "cuda") -> "AmDiagGmm":
        """gmm-init-mono: every pdf = 1 Gaussian at the global mean/var,
        optionally perturbed so pdfs are not identical."""
        D = len(glob_mean)
        rng = np.random.default_rng(seed)
        means = np.tile(glob_mean, (num_pdfs, 1, 1))
        if perturb > 0:
            means = means + perturb * np.sqrt(glob_var) * rng.standard_normal(
                (num_pdfs, 1, D))
        variances = np.tile(glob_var, (num_pdfs, 1, 1))
        weights = np.ones((num_pdfs, 1))
        return AmDiagGmm(weights, means, variances, device=device)

    # Copied from kaldi_tpu/am/gmm.py AmDiagGmm._natural_params.
    def _natural_params(self):
        w = self.weights
        valid = w > 0
        safe_var = np.where(valid[..., None], self.vars, 1.0)
        inv_var = 1.0 / safe_var
        mean_invvar = self.means * inv_var
        gconst = np.where(
            valid,
            np.log(np.maximum(w, 1e-300))
            - 0.5 * (self.dim * _LOG_2PI
                     + np.log(safe_var).sum(-1)
                     + (self.means * mean_invvar).sum(-1)),
            NEG)
        return (gconst.astype(np.float32),
                mean_invvar.astype(np.float32),
                inv_var.astype(np.float32))

    def refresh(self) -> None:
        """Invalidate the device constants after a parameter update."""
        self._kernel = None

    def to(self, device: torch.device | str) -> "AmDiagGmm":
        """Bind the model to ``device`` (in place; returns self).  The
        device tables are rebuilt only when the device changes."""
        device = resolve_device(device)
        if device != self.device:
            self.device = device
            self.refresh()
        return self

    def device_params(self) -> CudaGmm:
        """The natural parameters on the model's device, with the
        kernel's layout, built once until the next ``refresh``."""
        if self._kernel is None:
            self._kernel = CudaGmm(*self._natural_params(),
                                   device=self.device)
        return self._kernel

    def loglikes(self, feats) -> torch.Tensor:
        """(T, D) features (numpy or tensor) → (T, P) per-pdf
        log-likelihoods, float32 on the model's device."""
        return self.device_params()(self._on_device(feats))

    def _on_device(self, feats) -> torch.Tensor:
        x = torch.as_tensor(feats, dtype=torch.float32)
        return x.to(self.device).contiguous()

    def component_loglikes(self, x: torch.Tensor,
                           pdfs: torch.Tensor) -> torch.Tensor:
        """Per-slot log-likelihoods (T, M) of each frame of x (T, D)
        under its pdf ``pdfs`` (T,) int64, both on the model's device:
        gconst + x·(μ/σ²) − ½x²·(1/σ²); unused slots carry −1e30."""
        k = self.device_params()
        quad = torch.bmm(k.mean_invvar[pdfs], x[:, :, None])[:, :, 0] \
            - 0.5 * torch.bmm(k.inv_var[pdfs], (x * x)[:, :, None])[:, :, 0]
        return k.gconst[pdfs] + quad

    def component_posteriors(self, feats, pdfs) -> torch.Tensor:
        """Mixture posteriors γ (T, M), float32 on the model's device,
        for each frame's aligned pdf."""
        pdfs = torch.as_tensor(np.asarray(pdfs, np.int64)).to(self.device)
        return torch.softmax(
            self.component_loglikes(self._on_device(feats), pdfs), dim=1)


# ---------------------------------------------------------------------------
# Training: accumulators + MLE update (mle-diag-gmm.h semantics)
# ---------------------------------------------------------------------------

# Copied from kaldi_tpu/am/gmm.py GmmAccs.
@dataclasses.dataclass
class GmmAccs:
    """Per-pdf sufficient stats; add with '+' (gmm-sum-accs)."""
    occ: np.ndarray        # (P, M)
    mean_acc: np.ndarray   # (P, M, D)
    var_acc: np.ndarray    # (P, M, D)
    tot_like: float = 0.0
    tot_frames: float = 0.0

    @staticmethod
    def zeros(num_pdfs: int, max_mix: int, dim: int) -> "GmmAccs":
        return GmmAccs(np.zeros((num_pdfs, max_mix)),
                       np.zeros((num_pdfs, max_mix, dim)),
                       np.zeros((num_pdfs, max_mix, dim)))

    def __add__(self, other: "GmmAccs") -> "GmmAccs":
        return GmmAccs(self.occ + other.occ,
                       self.mean_acc + other.mean_acc,
                       self.var_acc + other.var_acc,
                       self.tot_like + other.tot_like,
                       self.tot_frames + other.tot_frames)


def _sum_by_pdf(t: torch.Tensor, pdfs: torch.Tensor, P: int) -> torch.Tensor:
    """Σ over frames of t's rows into P rows by pdf, in an order that does
    not change from run to run: ``index_put_(..., accumulate=True)``'s
    sorted accumulation, without its range check on the host (the
    ``.item()`` of the indices' min and max, a sync; the pdfs come from
    a transition model)."""
    out = t.new_zeros((P,) + tuple(t.shape[1:]))
    return torch._index_put_impl_(out, (pdfs,), t, accumulate=True,
                                  unsafe=True)


def accumulate_stats_device(am: AmDiagGmm, x: torch.Tensor,
                            pdfs: torch.Tensor):
    """The accumulation on the model's device, with no host sync: x (T,
    D) float32, pdfs (T,) int64 → (occ (P, M), mean_acc (P, M, D),
    var_acc (P, M, D), total log-likelihood ()) float32 tensors.

    Every sum is taken in an order that does not change from run to run:
    on a card ``index_add_`` adds the frames with atomics, in the order
    they land, and EM with mix-ups carries that order into which
    Gaussians split, so that two runs of a training (gmm-global-init-
    from-feats, the mini ladder) could end with other models and other
    WERs.  A model of one pdf (a global GMM) sums over the frames; more
    pdfs take ``index_put_``'s accumulate (``_sum_by_pdf``), which sorts
    the frames by pdf (stably) and adds each pdf's run in frame order."""
    comp = am.component_loglikes(x, pdfs)                   # (T, M)
    post = torch.softmax(comp, dim=1)
    P, M, D = am.num_pdfs, am.max_mix, am.dim
    px = post[:, :, None] * x[:, None, :]
    pxx = px * x[:, None, :]
    if P == 1:
        occ, mean_acc, var_acc = (t.sum(0, keepdim=True)
                                  for t in (post, px, pxx))
    else:
        occ, mean_acc, var_acc = (_sum_by_pdf(t, pdfs, P)
                                  for t in (post, px, pxx))
    return occ, mean_acc, var_acc, torch.logsumexp(comp, dim=1).sum()


def accumulate_stats(am: AmDiagGmm, feats, pdf_ali, accs: GmmAccs) -> float:
    """gmm-acc-stats-ali: Viterbi accumulation from a pdf alignment, on
    the model's device.  Returns the total log-likelihood of the
    frames."""
    pdfs = torch.as_tensor(np.asarray(pdf_ali, np.int64)).to(am.device)
    occ, mean_acc, var_acc, tot = accumulate_stats_device(
        am, am._on_device(feats), pdfs)
    accs.occ += occ.cpu().numpy().astype(np.float64)
    accs.mean_acc += mean_acc.cpu().numpy().astype(np.float64)
    accs.var_acc += var_acc.cpu().numpy().astype(np.float64)
    accs.tot_like += float(tot)
    accs.tot_frames += len(pdf_ali)
    return float(tot)


def accumulate_stats_twofeats(am: AmDiagGmm, feats_post, feats_stats,
                              pdf_ali: np.ndarray, accs: GmmAccs) -> None:
    """gmm-acc-stats-twofeats: component POSTERIORS computed on one
    feature stream (the adapted/SAT features the model was trained
    on), Gaussian STATS accumulated on another (the unadapted
    features).  One gmm-est pass over these stats yields the SAT
    'alimdl' — the model the first, transform-less decoding pass uses
    (steps/train_sat.sh final stage; steps/decode_fmllr.sh reads
    final.alimdl).  Posteriors on the device, sums in numpy, as the
    original."""
    post = am.component_posteriors(feats_post, pdf_ali).cpu().numpy() \
        .astype(np.float64)
    x = np.asarray(feats_stats, np.float64)
    pdfs = np.asarray(pdf_ali, np.int64)
    np.add.at(accs.occ, pdfs, post)
    np.add.at(accs.mean_acc, pdfs, post[:, :, None] * x[:, None, :])
    np.add.at(accs.var_acc, pdfs, post[:, :, None] * (x * x)[:, None, :])
    accs.tot_frames += len(pdfs)


# Copied from kaldi_tpu/am/gmm.py mle_update.
def mle_update(am: AmDiagGmm, accs: GmmAccs,
               min_occ: float = 3.0, var_floor: float = 1e-3,
               remove_low_count: bool = True) -> None:
    """gmm-est (MleDiagGmmUpdate): re-estimate weights/means/vars in
    place; components below min_occ keep their old parameters (or are
    dropped by zeroing their weight when others exist)."""
    occ = accs.occ
    valid_model = am.weights > 0
    update = (occ > min_occ) & valid_model
    tot_occ = occ.sum(axis=1, keepdims=True)

    new_w = np.where(valid_model, occ / np.maximum(tot_occ, 1e-10), 0.0)
    # pdfs with no data at all keep old weights
    has_data = tot_occ[:, 0] > min_occ
    am.weights = np.where(has_data[:, None], new_w, am.weights)

    safe_occ = np.maximum(occ, 1e-10)[..., None]
    new_mean = accs.mean_acc / safe_occ
    new_var = np.maximum(accs.var_acc / safe_occ - new_mean ** 2, var_floor)
    am.means = np.where(update[..., None], new_mean, am.means)
    am.vars = np.where(update[..., None], new_var, am.vars)

    if remove_low_count:
        dead = valid_model & ~update & has_data[:, None] \
            & (am.weights < 1e-8)
        if dead.any():
            am.weights = np.where(dead, 0.0, am.weights)
    # renormalize
    wsum = am.weights.sum(axis=1, keepdims=True)
    am.weights = am.weights / np.maximum(wsum, 1e-10)
    am.refresh()
    if accs.tot_frames > 0:
        log.info("mle_update: avg loglike/frame %.4f over %.0f frames",
                 accs.tot_like / accs.tot_frames, accs.tot_frames)


# Copied from kaldi_tpu/am/gmm.py map_update.
def map_update(am: AmDiagGmm, accs: GmmAccs, mean_tau: float = 10.0,
               weight_tau: float = 0.0, var_tau: float = 0.0,
               var_floor: float = 1e-3) -> None:
    """gmm-adapt-map (MapDiagGmmUpdate, mle-diag-gmm.h): MAP
    re-estimation interpolating new statistics with the prior (current)
    parameters, per Gauvain & Lee:

        μ' = (γ·x̄ + τ·μ₀) / (γ + τ)

    and analogously for weights/variances when their τ > 0.  τ = 0
    disables that parameter's update entirely for weights/vars (the
    reference's --weight-tau / --var-tau default behaviour is
    means-only adaptation, used for per-speaker / per-domain adapted
    models)."""
    occ = accs.occ                                     # (P, M)
    safe = np.maximum(occ, 1e-10)[..., None]
    xbar = accs.mean_acc / safe
    valid = (am.weights > 0) & (occ > 0)
    new_mean = (occ[..., None] * xbar + mean_tau * am.means) \
        / (occ[..., None] + mean_tau)
    am.means = np.where(valid[..., None], new_mean, am.means)
    if var_tau > 0:
        ex2 = accs.var_acc / safe
        sample_var = np.maximum(ex2 - xbar ** 2, var_floor)
        new_var = (occ[..., None] * sample_var + var_tau * am.vars) \
            / (occ[..., None] + var_tau)
        am.vars = np.where(valid[..., None],
                           np.maximum(new_var, var_floor), am.vars)
    if weight_tau > 0:
        tot = occ.sum(axis=1, keepdims=True)
        ml_w = occ / np.maximum(tot, 1e-10)
        new_w = (tot * ml_w + weight_tau * am.weights) \
            / (tot + weight_tau)
        has = tot[:, 0] > 0
        am.weights = np.where(has[:, None], new_w, am.weights)
        am.weights /= np.maximum(am.weights.sum(axis=1, keepdims=True),
                                 1e-10)
    am.refresh()
    if accs.tot_frames > 0:
        log.info("map_update: tau=%.1f, avg loglike/frame %.4f over "
                 "%.0f frames", mean_tau,
                 accs.tot_like / accs.tot_frames, accs.tot_frames)


# Copied from kaldi_tpu/am/gmm.py mixup; the new model is on am's device.
def mixup(am: AmDiagGmm, target_tot_gauss: int, perturb: float = 0.01,
          seed: int = 0) -> AmDiagGmm:
    """gmm-mixup: split heaviest components (weighted by pdf occupancy
    share) until the model has target_tot_gauss Gaussians."""
    rng = np.random.default_rng(seed)
    P, M, D = am.means.shape
    cur = am.num_gauss()
    n_new = target_tot_gauss - cur
    if n_new <= 0:
        return am
    # candidate: (weight, pdf, mix) — split globally largest weights
    grow = max(M, int(np.ceil((cur + n_new) / P)))
    weights = np.zeros((P, grow))
    means = np.zeros((P, grow, D))
    variances = np.ones((P, grow, D))
    weights[:, :M] = am.weights
    means[:, :M] = am.means
    variances[:, :M] = am.vars
    next_slot = (am.weights > 0).sum(axis=1).astype(int)
    flat = [(-weights[p, m], p, m) for p in range(P) for m in range(M)
            if weights[p, m] > 0]
    heapq.heapify(flat)
    for _ in range(n_new):
        while True:
            negw, p, m = heapq.heappop(flat)
            if next_slot[p] < grow:
                break
        s = next_slot[p]
        next_slot[p] += 1
        w = -negw / 2.0
        weights[p, m] = w
        weights[p, s] = w
        offset = perturb * np.sqrt(variances[p, m]) * rng.standard_normal(D)
        means[p, s] = means[p, m] + offset
        means[p, m] = means[p, m] - offset
        variances[p, s] = variances[p, m]
        heapq.heappush(flat, (-w, p, m))
        heapq.heappush(flat, (-w, p, s))
    out = AmDiagGmm(weights, means, variances, device=am.device)
    log.info("mixup: %d → %d gaussians (max-mix %d)", cur,
             out.num_gauss(), grow)
    return out


# Copied from kaldi_tpu/am/gmm.py global_stats.
def global_stats(feats_iter) -> Tuple[np.ndarray, np.ndarray]:
    """Global mean/var over an iterable of (T, D) matrices (flat start)."""
    n, s, ss = 0.0, None, None
    for m in feats_iter:
        m = np.asarray(m, dtype=np.float64)
        if s is None:
            s = m.sum(0)
            ss = (m ** 2).sum(0)
        else:
            s += m.sum(0)
            ss += (m ** 2).sum(0)
        n += m.shape[0]
    mean = s / n
    var = np.maximum(ss / n - mean ** 2, 1e-6)
    return mean, var
