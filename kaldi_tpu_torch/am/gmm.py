"""Diagonal-covariance GMM acoustic model, for inference.

Port of ``AmDiagGmm`` from kaldi_tpu/am/gmm.py (parity targets
src/gmm/diag-gmm.h, am-diag-gmm.h).  The whole model is three dense
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
JAX-side model across.  The accumulators, ``component_posteriors``,
the MLE/MAP updates, mix-up and flat start belong to the GMM-training
slice and are not ported yet.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from kaldi_tpu_torch.device import resolve_device
from kaldi_tpu_torch.ops.gmm import NEG, CudaGmm

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
        x = torch.as_tensor(feats, dtype=torch.float32)
        return self.device_params()(x.to(self.device).contiguous())
