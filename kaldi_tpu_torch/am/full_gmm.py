"""Port of kaldi_tpu/am/full_gmm.py: full-covariance GMMs.

Parity target: src/gmm/full-gmm.h (FullGmm), mle-full-gmm.h
(AccumFullGmm / MleFullGmmUpdate).  Used by the reference mainly as the
UBM for i-vector systems (full-UBM stage of steps/train_diag_ubm.sh →
train_full_ubm.sh).

The parameters stay float64 numpy on the host, as in the original, and
so do the Cholesky, the inverse covariances, the Gaussian constants
(``refresh``), the eigenvalue floor of the update and the accumulators.
The frame work runs on the model's ``device`` in float64: per-component
log-likelihoods are one batched product for the linear term
x·(Σ⁻¹μ) and one for the quadratic form xᵀΣ⁻¹x, then logsumexp or
softmax over the components; ``AccumFullGmm.accumulate`` sums γ, γx and
γxxᵀ there and adds them to its float64 host arrays.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from kaldi_tpu_torch.core.logging import get_logger
from kaldi_tpu_torch.device import resolve_device

log = get_logger(__name__)

_LOG_2PI = math.log(2.0 * math.pi)


class FullGmm:
    """Single-state full-covariance GMM (the UBM role), float64 on the
    host, its frame work on ``device``."""

    def __init__(self, weights: np.ndarray, means: np.ndarray,
                 covars: np.ndarray, device: torch.device | str = "cuda"):
        """weights (M,), means (M, D), covars (M, D, D)."""
        self.weights = weights.astype(np.float64)
        self.means = means.astype(np.float64)
        self.covars = covars.astype(np.float64)
        self.device = resolve_device(device)
        self.refresh()

    @property
    def num_mix(self) -> int:
        return len(self.weights)

    @property
    def dim(self) -> int:
        return self.means.shape[1]

    # Copied from kaldi_tpu/am/full_gmm.py FullGmm.refresh (+ the device
    # tables, rebuilt on next use).
    def refresh(self) -> None:
        M, D = self.means.shape
        self.inv_covars = np.zeros_like(self.covars)
        self.gconsts = np.zeros(M)
        for m in range(M):
            c = self.covars[m] + 1e-8 * np.eye(D)
            L = np.linalg.cholesky(c)
            self.inv_covars[m] = np.linalg.inv(c)
            logdet = 2.0 * np.log(np.diag(L)).sum()
            mu = self.means[m]
            self.gconsts[m] = (np.log(max(self.weights[m], 1e-300))
                               - 0.5 * (D * _LOG_2PI + logdet
                                        + mu @ self.inv_covars[m] @ mu))
        self._tables = None

    def _device_tables(self):
        """(gconsts (M,), Σ⁻¹μ (D, M), Σ⁻¹ (M, D, D)) float64 on the
        device, built once until the next ``refresh``."""
        if self._tables is None:
            lin = np.einsum("mde,me->dm", self.inv_covars, self.means)
            self._tables = tuple(
                torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for a in (self.gconsts, lin, self.inv_covars))
        return self._tables

    def _on_device(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float64).to(self.device)

    # Port of kaldi_tpu/am/full_gmm.py FullGmm.component_loglikes.
    def component_loglikes(self, x) -> torch.Tensor:
        """(T, D) → (T, M) per-component log-likelihoods, float64 on the
        model's device."""
        gconsts, lin, inv = self._device_tables()
        x = self._on_device(x)
        quad = (torch.matmul(x[None], inv) * x[None]).sum(-1)     # (M, T)
        return gconsts[None, :] + x @ lin - 0.5 * quad.T

    # Port of kaldi_tpu/am/full_gmm.py FullGmm.loglikes.
    def loglikes(self, x) -> torch.Tensor:
        """(T, D) → (T,) frame log-likelihoods, float64 on the device."""
        return torch.logsumexp(self.component_loglikes(x), dim=1)

    # Port of kaldi_tpu/am/full_gmm.py FullGmm.posteriors.
    def posteriors(self, x) -> torch.Tensor:
        """(T, D) → (T, M) component posteriors, float64 on the device."""
        return torch.softmax(self.component_loglikes(x), dim=1)

    # Copied from kaldi_tpu/am/full_gmm.py FullGmm.from_diag (+ device).
    @staticmethod
    def from_diag(weights: np.ndarray, means: np.ndarray,
                  variances: np.ndarray,
                  device: torch.device | str = "cuda") -> "FullGmm":
        """Initialize from a diagonal GMM (train_full_ubm.sh start)."""
        M, D = means.shape
        covars = np.zeros((M, D, D))
        for m in range(M):
            covars[m] = np.diag(variances[m])
        return FullGmm(weights, means, covars, device=device)


class AccumFullGmm:
    """Sufficient stats: occupancy, Σγx, Σγxxᵀ (mle-full-gmm.h), float64
    on the host."""

    # frames a batched γxxᵀ product takes at once (its (M, CHUNK, D)
    # operand bounds the device memory)
    CHUNK = 2048

    def __init__(self, num_mix: int, dim: int):
        self.occ = np.zeros(num_mix)
        self.mean_acc = np.zeros((num_mix, dim))
        self.cov_acc = np.zeros((num_mix, dim, dim))

    # Port of kaldi_tpu/am/full_gmm.py AccumFullGmm.accumulate.
    def accumulate(self, gmm: FullGmm, x) -> float:
        """Add the frames' statistics (float64 sums on the model's
        device); → their total log-likelihood."""
        x = gmm._on_device(x)
        comp = gmm.component_loglikes(x)
        post = torch.softmax(comp, dim=1)
        self.occ += post.sum(0).cpu().numpy()
        self.mean_acc += (post.T @ x).cpu().numpy()
        cov = torch.zeros(self.cov_acc.shape, dtype=torch.float64,
                          device=x.device)
        for s in range(0, x.shape[0], self.CHUNK):
            xs, ps = x[s:s + self.CHUNK], post[s:s + self.CHUNK]
            cov += torch.matmul((ps.T[:, :, None] * xs[None]).transpose(1, 2),
                                xs[None])
        self.cov_acc += cov.cpu().numpy()
        return float(torch.logsumexp(comp, dim=1).sum())


# Copied from kaldi_tpu/am/full_gmm.py mle_full_gmm_update.
def mle_full_gmm_update(gmm: FullGmm, accs: AccumFullGmm,
                        min_occ: float = 10.0,
                        cov_floor: float = 1e-3) -> None:
    M, D = gmm.means.shape
    tot = accs.occ.sum()
    for m in range(M):
        if accs.occ[m] < min_occ:
            continue
        gmm.weights[m] = accs.occ[m] / max(tot, 1e-10)
        mu = accs.mean_acc[m] / accs.occ[m]
        cov = accs.cov_acc[m] / accs.occ[m] - np.outer(mu, mu)
        # floor eigenvalues
        evals, evecs = np.linalg.eigh(cov)
        evals = np.maximum(evals, cov_floor)
        gmm.means[m] = mu
        gmm.covars[m] = (evecs * evals) @ evecs.T
    gmm.weights /= gmm.weights.sum()
    gmm.refresh()
