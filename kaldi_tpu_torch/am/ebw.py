"""Port of kaldi_tpu/am/ebw.py: discriminative GMM training, MMI with
Extended Baum-Welch updates.

Parity targets: src/gmm/ebw-diag-gmm.h (EbwUpdate), the
gmm-rescore-lattice / gmm-acc-stats2 MMI flow of steps/train_mmi.sh.

Numerator statistics come from the forced alignment; denominator
statistics from the decode lattice's sum forward-backward pdf
posteriors (the competing-hypothesis mass).  The EBW update

    μ' = (x_num − x_den + D μ) / (γ_num − γ_den + D)

uses the standard per-Gaussian smoothing D = max(E·γ_den, D_min·γ_num)
keeping variances positive.

``raw_lattice_pdf_posteriors`` and ``ebw_update`` are the original's
host numpy, copied.  The original's ``accumulate_den_stats`` runs one
jitted mixture posterior per pdf over the frames that pdf has mass on;
the port runs one ``AmDiagGmm.component_posteriors`` call over every
(frame, pdf) pair above 1e-6 on the model's device and sums the
weighted statistics by pdf there in float64 (``accumulate_post_stats``,
which gmm-acc-stats also uses).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from kaldi_tpu_torch.am.gmm import AmDiagGmm, GmmAccs, _sum_by_pdf
from kaldi_tpu_torch.core.logging import get_logger
from kaldi_tpu_torch.lattice.lattice import Lattice

log = get_logger(__name__)


# Copied from kaldi_tpu/am/ebw.py raw_lattice_pdf_posteriors.
def raw_lattice_pdf_posteriors(lat: Lattice, T: int, tid_to_pdf: np.ndarray,
                               num_pdfs: int, acoustic_scale: float = 1.0
                               ) -> np.ndarray:
    """Sum forward-backward over a raw (frame-level) lattice →
    per-frame pdf posteriors (T, num_pdfs) — the role of
    lattice-to-post in the MMI recipe."""
    n = lat.num_states
    order = lat.top_order()
    # frame index per node: emitting arcs advance one frame
    time = np.full(n, -1, np.int64)
    time[lat.start] = 0
    for s in order:
        if time[s] < 0:
            continue
        for a in lat.arcs[s]:
            t = time[s] + (1 if a.ilabel else 0)
            time[a.nextstate] = max(time[a.nextstate], t)

    def arc_ll(a):
        return -(a.graph_cost + acoustic_scale * a.acoustic_cost)

    alpha = np.full(n, -np.inf)
    alpha[lat.start] = 0.0
    for s in order:
        if alpha[s] == -np.inf:
            continue
        for a in lat.arcs[s]:
            v = alpha[s] + arc_ll(a)
            alpha[a.nextstate] = np.logaddexp(alpha[a.nextstate], v)
    beta = np.full(n, -np.inf)
    for s, (gc, ac) in lat.finals.items():
        beta[s] = -(gc + acoustic_scale * ac)
    for s in reversed(order):
        for a in lat.arcs[s]:
            beta[s] = np.logaddexp(beta[s], arc_ll(a) + beta[a.nextstate])
    total = beta[lat.start]
    post = np.zeros((T, num_pdfs))
    for s in order:
        if alpha[s] == -np.inf or time[s] < 0:
            continue
        for a in lat.arcs[s]:
            if a.ilabel == 0:
                continue
            t = time[s]
            if t >= T:
                continue
            lp = alpha[s] + arc_ll(a) + beta[a.nextstate] - total
            post[t, tid_to_pdf[a.ilabel]] += math.exp(min(lp, 0.0))
    return post


def accumulate_post_stats(am: AmDiagGmm, feats: np.ndarray, ts: np.ndarray,
                          pdfs: np.ndarray, weights: np.ndarray,
                          accs: GmmAccs) -> None:
    """Weighted statistics of (frame, pdf, weight) entries: frame
    ``ts[i]`` of ``feats`` under pdf ``pdfs[i]`` with weight
    ``weights[i]``, its mixture posteriors from one
    ``component_posteriors`` call on the model's device, the weighted
    occupancies and first and second moments summed by pdf there in
    float64 (``_sum_by_pdf``: one order every run), added to ``accs``."""
    if len(ts) == 0:
        return
    dev = am.device
    x = torch.as_tensor(np.asarray(feats)[ts], dtype=torch.float64).to(dev)
    comp = am.component_posteriors(x, pdfs).double()
    wp = comp * torch.as_tensor(weights, dtype=torch.float64).to(dev)[:, None]
    p = torch.as_tensor(pdfs, dtype=torch.int64).to(dev)
    px = wp[:, :, None] * x[:, None, :]
    for name, t in (("occ", wp), ("mean_acc", px),
                    ("var_acc", px * x[:, None, :])):
        getattr(accs, name)[...] += \
            _sum_by_pdf(t, p, am.num_pdfs).cpu().numpy()


# Port of kaldi_tpu/am/ebw.py accumulate_den_stats.
def accumulate_den_stats(am: AmDiagGmm, feats: np.ndarray,
                         pdf_post: np.ndarray, accs: GmmAccs) -> None:
    """Accumulate denominator stats weighted by per-frame pdf posteriors
    (T, P): every (frame, pdf) pair above 1e-6 at once."""
    ts, pdfs = np.nonzero(pdf_post > 1e-6)
    accumulate_post_stats(am, feats, ts, pdfs, pdf_post[ts, pdfs], accs)


# Copied from kaldi_tpu/am/ebw.py ebw_update.
def ebw_update(am: AmDiagGmm, num: GmmAccs, den: GmmAccs,
               E: float = 2.0, d_min_factor: float = 0.5,
               var_floor: float = 1e-3) -> float:
    """EBW mean/variance update (ebw-diag-gmm.cc UpdateEbwDiagGmm).
    Returns the (approximate) MMI auxiliary-function improvement."""
    valid = am.weights > 0
    gamma_n = num.occ
    gamma_d = den.occ
    D = np.maximum(E * gamma_d, d_min_factor * np.maximum(gamma_n, 1e-10))
    # increase D where the variance would go negative
    for _ in range(10):
        denom = gamma_n - gamma_d + D
        ok = denom > 1e-10
        mean_new = np.where(
            ok[..., None],
            (num.mean_acc - den.mean_acc + D[..., None] * am.means)
            / np.maximum(denom[..., None], 1e-10), am.means)
        var_new = np.where(
            ok[..., None],
            (num.var_acc - den.var_acc
             + D[..., None] * (am.vars + am.means ** 2))
            / np.maximum(denom[..., None], 1e-10) - mean_new ** 2,
            am.vars)
        bad = (var_new <= var_floor / 2).any(axis=2) & valid & ok
        if not bad.any():
            break
        D = np.where(bad, D * 2.0, D)
    var_new = np.maximum(var_new, var_floor)
    update = valid & (gamma_n + gamma_d > 1e-3)
    am.means = np.where(update[..., None], mean_new, am.means)
    am.vars = np.where(update[..., None], var_new, am.vars)
    am.refresh()
    log.info("ebw_update: num occ %.0f den occ %.0f", gamma_n.sum(),
             gamma_d.sum())
    return float((gamma_n - gamma_d).sum())
