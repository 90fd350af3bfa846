"""Feature-space transforms: LDA, MLLT, fMLLR.

Port of kaldi_tpu/am/transforms.py (parity targets
src/transform/lda-estimate.h, mllt.h, fmllr-diag-gmm.h).
``apply_transform`` (transform-feats) is one product on the features'
device, for an LDA, LDA+MLLT or fMLLR matrix.  The estimators are the
original's small-matrix host numpy, copied: they run once per training
iteration over accumulated statistics.  The fMLLR accumulators take the
GMM's mixture posteriors from the model's device.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from kaldi_tpu_torch.core.logging import KaldiError, get_logger

log = get_logger(__name__)


def apply_transform(feats: torch.Tensor, mat) -> torch.Tensor:
    """(T, D) float32 features times ``mat`` (numpy or tensor), which is
    (out_dim, D) linear or (out_dim, D+1) affine → (T, out_dim) float32
    on the features' device."""
    mat = torch.as_tensor(mat, dtype=feats.dtype).to(feats.device)
    D = feats.shape[1]
    if mat.shape[1] == D:
        return feats @ mat.T
    if mat.shape[1] == D + 1:
        return feats @ mat[:, :D].T + mat[:, D]
    raise KaldiError(f"transform shape {tuple(mat.shape)} vs dim {D}")


# ---------------------------------------------------------------------------
# LDA
# ---------------------------------------------------------------------------

# Copied from kaldi_tpu/am/transforms.py LdaEstimate.
class LdaEstimate:
    """Class-indexed 1st/2nd order stats → LDA matrix (lda-estimate.h)."""

    def __init__(self, num_classes: int, dim: int):
        self.counts = np.zeros(num_classes)
        self.first = np.zeros((num_classes, dim))
        self.total_second = np.zeros((dim, dim))

    def accumulate(self, x: np.ndarray, cls: int, weight: float = 1.0) -> None:
        self.counts[cls] += weight
        self.first[cls] += weight * x
        self.total_second += weight * np.outer(x, x)

    def accumulate_batch(self, feats: np.ndarray, classes: np.ndarray) -> None:
        for c in np.unique(classes):
            sel = feats[classes == c]
            self.counts[c] += len(sel)
            self.first[c] += sel.sum(axis=0)
        self.total_second += feats.T @ feats

    def estimate(self, target_dim: int,
                 within_class_factor: float = 1.0) -> np.ndarray:
        """Returns (target_dim, dim+1) affine LDA (includes mean offset,
        as the reference's lda-estimate writes by default)."""
        tot = self.counts.sum()
        if tot == 0:
            raise KaldiError("LdaEstimate: no stats")
        mean = self.first.sum(axis=0) / tot
        # between-class scatter
        bc = np.zeros_like(self.total_second)
        for c in range(len(self.counts)):
            if self.counts[c] == 0:
                continue
            m = self.first[c] / self.counts[c] - mean
            bc += self.counts[c] * np.outer(m, m)
        bc /= tot
        total_cov = self.total_second / tot - np.outer(mean, mean)
        wc = total_cov - bc
        # solve generalized eig: bc v = λ wc v  via whitening
        wc = wc + 1e-6 * np.eye(len(wc)) * np.trace(wc) / len(wc)
        evals_w, evecs_w = np.linalg.eigh(wc)
        whiten = evecs_w @ np.diag(1.0 / np.sqrt(np.maximum(evals_w, 1e-10)))
        m = whiten.T @ bc @ whiten
        evals, evecs = np.linalg.eigh(m)
        order = np.argsort(evals)[::-1][:target_dim]
        proj = (whiten @ evecs[:, order]).T * math.sqrt(within_class_factor)
        offset = -proj @ mean
        out = np.concatenate([proj, offset[:, None]], axis=1)
        log.info("LDA: kept %d dims, between-class eigs %s", target_dim,
                 np.round(evals[order][:5], 2))
        return out


# ---------------------------------------------------------------------------
# MLLT (global semi-tied covariance)
# ---------------------------------------------------------------------------

# Copied from kaldi_tpu/am/transforms.py MlltAccs.
class MlltAccs:
    """G_i = Σ_g γ_g / σ²_{g,i} (x−μ_g)(x−μ_g)ᵀ accumulators (mllt.h)."""

    def __init__(self, dim: int):
        self.G = np.zeros((dim, dim, dim))
        self.beta = 0.0

    def accumulate(self, post: np.ndarray, feats: np.ndarray,
                   means: np.ndarray, inv_vars: np.ndarray) -> None:
        """post (T, M) mixture posteriors of the aligned pdf; feats (T, D);
        means/inv_vars (T, M, D) gathered per frame."""
        T, M = post.shape
        D = feats.shape[1]
        diff = feats[:, None, :] - means            # (T, M, D)
        w = post[:, :, None] * inv_vars             # (T, M, D) γ/σ² per dim
        for i in range(D):
            # Σ_t Σ_m w[t,m,i] diff[t,m,:] diffᵀ
            wd = (w[:, :, i:i + 1] * diff).reshape(T * M, D)
            self.G[i] += wd.T @ diff.reshape(T * M, D)
        self.beta += post.sum()

    def update(self, num_iters: int = 20) -> Tuple[np.ndarray, float]:
        """Row-wise iterative MLLT update (mllt.cc MlltAccs::Update).
        Returns (M, objf improvement per frame)."""
        D = self.G.shape[0]
        M = np.eye(D)
        if self.beta == 0:
            return M, 0.0
        Ginv = [np.linalg.inv(self.G[i] + 1e-8 * np.eye(D) *
                              np.trace(self.G[i]) / D) for i in range(D)]

        def objf(M):
            sign, logdet = np.linalg.slogdet(M)
            val = self.beta * logdet
            for i in range(D):
                val -= 0.5 * M[i] @ self.G[i] @ M[i]
            return val

        start = objf(M)
        for _ in range(num_iters):
            for i in range(D):
                cof = np.linalg.inv(M).T[i]          # cofactor row dir
                gi = Ginv[i]
                quad = cof @ gi @ cof
                scale = math.sqrt(self.beta / max(quad, 1e-20))
                M[i] = scale * (gi @ cof)
        impr = (objf(M) - start) / self.beta
        log.info("MLLT: objf impr %.4f per frame over %.0f frames",
                 impr, self.beta)
        return M, impr


# ---------------------------------------------------------------------------
# fMLLR (per-speaker affine transform, SAT)
# ---------------------------------------------------------------------------

# Copied from kaldi_tpu/am/transforms.py FmllrAccs.
class FmllrAccs:
    """K and per-row G accumulators (fmllr-diag-gmm.h FmllrDiagGmmAccs)."""

    def __init__(self, dim: int):
        self.K = np.zeros((dim, dim + 1))
        self.G = np.zeros((dim, dim + 1, dim + 1))
        self.beta = 0.0

    def accumulate(self, post: np.ndarray, feats: np.ndarray,
                   means: np.ndarray, inv_vars: np.ndarray) -> None:
        """post (T, M); feats (T, D); means/inv_vars (T, M, D)."""
        T, M = post.shape
        D = feats.shape[1]
        xp = np.concatenate([feats, np.ones((T, 1))], axis=1)   # (T, D+1)
        w = post[:, :, None] * inv_vars                          # (T, M, D)
        # K += Σ γ/σ² μ x⁺ᵀ
        wm = (w * means).sum(axis=1)                             # (T, D)
        self.K += wm.T @ xp
        # G_i += Σ γ/σ²_i x⁺ x⁺ᵀ
        wi = w.sum(axis=1)                                       # (T, D)
        for i in range(D):
            xw = xp * wi[:, i:i + 1]
            self.G[i] += xw.T @ xp
        self.beta += post.sum()

    def update(self, num_iters: int = 20,
               min_count: float = 500.0) -> Tuple[np.ndarray, float]:
        """Iterative row update (fmllr-diag-gmm.cc ComputeFmllrMatrixDiagGmm).
        Returns ((D, D+1) transform, objf improvement/frame); identity if
        below min_count."""
        D = self.K.shape[0]
        W = np.concatenate([np.eye(D), np.zeros((D, 1))], axis=1)
        if self.beta < min_count:
            log.info("fMLLR: count %.1f < %.1f, keeping identity", self.beta,
                     min_count)
            return W, 0.0
        Ginv = [np.linalg.inv(self.G[i] + 1e-6 * np.eye(D + 1) *
                              (np.trace(self.G[i]) / (D + 1) + 1))
                for i in range(D)]

        def objf(W):
            A = W[:, :D]
            sign, logdet = np.linalg.slogdet(A)
            val = self.beta * logdet
            for i in range(D):
                val += W[i] @ self.K[i] - 0.5 * W[i] @ self.G[i] @ W[i]
            return val

        start = objf(W)
        for _ in range(num_iters):
            for i in range(D):
                A = W[:, :D]
                cof = np.linalg.inv(A).T[i]
                p = np.concatenate([cof, [0.0]])
                gi = Ginv[i]
                # solve for row: W_i = (β p + ... ) per the quadratic eqn
                k = self.K[i]
                a = p @ gi @ p
                b = p @ gi @ k
                # stationary point of β log|d| - ½ w G w + w k along w =
                # (d p + k) G⁻¹ parameterization (Kaldi's quadratic solve)
                disc = b * b + 4 * a * self.beta
                d = (-b + math.sqrt(max(disc, 0.0))) / (2 * a) if a > 1e-20 \
                    else 0.0
                W[i] = (d * p + k) @ gi
        impr = (objf(W) - start) / self.beta
        log.info("fMLLR: objf impr %.4f per frame over %.0f frames",
                 impr, self.beta)
        return W, impr


# Copied from kaldi_tpu/am/transforms.py; the posteriors come from the
# model's device (AmDiagGmm.component_posteriors).
def accumulate_fmllr_for_utt(accs: FmllrAccs, am, feats: np.ndarray,
                             pdf_ali: np.ndarray) -> None:
    """Accumulate fMLLR stats from a pdf alignment using the GMM's
    mixture posteriors (gmm-est-fmllr flow: ali-to-post →
    weight-silence-post → AccumulateFromPosteriors)."""
    post = am.component_posteriors(feats, pdf_ali).cpu().numpy()
    means = am.means[pdf_ali]                      # (T, M, D)
    inv_vars = 1.0 / am.vars[pdf_ali]
    accs.accumulate(post, np.asarray(feats), means, inv_vars)


# Copied from kaldi_tpu/am/transforms.py; posteriors as above.
def accumulate_fmllr_from_post(accs: FmllrAccs, am, feats: np.ndarray,
                               frame_post) -> None:
    """Accumulate fMLLR stats from per-frame PDF posteriors
    (gmm-est-fmllr's posterior path: lattice-to-post →
    weight-silence-post → AccumulateFromPosteriors).  frame_post is a
    length-T list of [(pdf, weight), ...]; each entry becomes a
    weighted pseudo-frame, so soft lattice posteriors contribute
    fractionally where a 1-best alignment would commit fully."""
    ts, pdfs, ws = [], [], []
    for t, items in enumerate(frame_post):
        for pdf, w in items:
            if w <= 0:
                continue
            ts.append(t)
            pdfs.append(int(pdf))
            ws.append(float(w))
    if not ts:
        return
    t_arr = np.asarray(ts, np.int64)
    pdf_arr = np.asarray(pdfs, np.int32)
    w_arr = np.asarray(ws, np.float32)
    x = np.asarray(feats, np.float32)[t_arr]
    post = am.component_posteriors(x, pdf_arr).cpu().numpy() \
        * w_arr[:, None]
    means = am.means[pdf_arr]
    inv_vars = 1.0 / am.vars[pdf_arr]
    accs.accumulate(post, x, means, inv_vars)


# Copied from kaldi_tpu/am/transforms.py compose_transforms.
def compose_transforms(a: np.ndarray, b: np.ndarray,
                       b_is_affine: bool = False) -> np.ndarray:
    """Compose feature transforms so apply(x, result) == apply(apply(x,
    b), a)  (compose-transforms.cc ComposeTransforms).  Either operand
    may be linear (d_out, d_in) or affine (d_out, d_in+1); `b_is_affine`
    disambiguates b's last column (the reference's --b-is-affine flag —
    shapes alone cannot always tell).  The result is affine iff either
    operand is."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    d_mid = b.shape[0]
    if a.shape[1] == d_mid:
        a_lin, a_off, a_affine = a, np.zeros(a.shape[0]), False
    elif a.shape[1] == d_mid + 1:
        a_lin, a_off, a_affine = a[:, :d_mid], a[:, d_mid], True
    else:
        raise KaldiError(
            f"compose_transforms: a {a.shape} does not consume b rows "
            f"{d_mid}")
    b_lin = b[:, :-1] if b_is_affine else b
    b_off = b[:, -1] if b_is_affine else np.zeros(d_mid)
    out_lin = a_lin @ b_lin
    if a_affine or b_is_affine:
        off = a_lin @ b_off + a_off
        return np.concatenate([out_lin, off[:, None]],
                              axis=1).astype(np.float32)
    return out_lin.astype(np.float32)
