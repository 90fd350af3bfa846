"""Feature-space transforms, applied.

Port of ``apply_transform`` from kaldi_tpu/am/transforms.py
(transform-feats): one product on the features' device, for an LDA,
LDA+MLLT or fMLLR matrix.  The estimators (LDA, MLLT, fMLLR) run on
training statistics and belong to the training slice.
"""

from __future__ import annotations

import torch

from kaldi_tpu_torch.core.logging import KaldiError


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
