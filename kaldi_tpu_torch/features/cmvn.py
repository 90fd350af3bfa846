"""Cepstral mean/variance normalization statistics.

Port of kaldi_tpu/features/cmvn.py (parity target src/transform/cmvn.h —
ComputeCmvnStats / ApplyCmvn).  Stats keep the reference wire format, a
(2, dim+1) float64 matrix

  row 0: [sum_1..sum_D, count]
  row 1: [sumsq_1..sumsq_D, 0]

so per-speaker stats are sums of per-utterance stats.  Stats are
float64 tensors on the features' device, summed there without a trip
through the host; ``apply_cmvn`` takes the mean and scale in float64
and applies them in float32.
"""

from __future__ import annotations

from typing import Sequence

import torch


def compute_cmvn_stats(feats) -> torch.Tensor:
    """(T, D) features (numpy or tensor) → (2, D+1) float64 stats on
    the features' device."""
    x = torch.as_tensor(feats).to(torch.float64)
    T, D = x.shape
    stats = x.new_zeros((2, D + 1))
    stats[0, :D] = x.sum(dim=0)
    stats[0, D] = T
    stats[1, :D] = (x * x).sum(dim=0)
    return stats


def sum_cmvn_stats(stats_list: Sequence) -> torch.Tensor:
    return torch.stack([torch.as_tensor(s, dtype=torch.float64)
                        for s in stats_list]).sum(dim=0)


def apply_cmvn(feats: torch.Tensor, stats, norm_vars: bool = False
               ) -> torch.Tensor:
    """Normalize (T, D) float32 features by (2, D+1) stats (numpy or
    tensor); the result is float32 on the features' device."""
    stats = torch.as_tensor(stats, dtype=torch.float64).to(feats.device)
    D = feats.shape[1]
    count = stats[0, D]
    mean = stats[0, :D] / count
    out = feats - mean.to(feats.dtype)[None, :]
    if norm_vars:
        var = stats[1, :D] / count - mean ** 2
        scale = 1.0 / torch.sqrt(torch.clamp_min(var, 1e-20))
        out = out * scale.to(feats.dtype)[None, :]
    return out
