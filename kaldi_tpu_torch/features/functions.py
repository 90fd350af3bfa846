"""Post-processing: deltas and splicing.

Port of ``DeltaFeaturesOptions``, ``delta_scales``, ``add_deltas`` and
``splice_frames`` from kaldi_tpu/features/functions.py (parity targets
src/feat/feature-functions.h DeltaFeatures, SpliceFrames).  Both are
shifted slices of the edge-replicated utterance, summed in the
original's order so that float32 results agree to rounding.
``sliding_window_cmn`` is not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class DeltaFeaturesOptions:
    order: int = 2
    window: int = 2


# Copied from kaldi_tpu/features/functions.py delta_scales.
def delta_scales(opts: DeltaFeaturesOptions) -> list[np.ndarray]:
    """Per-order filter coefficients (feature-functions.cc DeltaFeatures ctor)."""
    scales = [np.array([1.0], dtype=np.float64)]
    for i in range(1, opts.order + 1):
        window = opts.window
        prev = scales[i - 1]
        normalizer = sum(j * j for j in range(1, window + 1)) * 2.0
        prev_offset = (len(prev) - 1) // 2
        cur_offset = prev_offset + window
        cur = np.zeros(len(prev) + 2 * window)
        for j in range(-window, window + 1):
            if j != 0:
                for k in range(-prev_offset, prev_offset + 1):
                    cur[j + k + cur_offset] += (j / normalizer) * prev[k + prev_offset]
        scales.append(cur)
    return [s.astype(np.float32) for s in scales]


def _pad_edges(feats: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """Replicate the first frame ``left`` and the last ``right`` times."""
    return torch.cat([feats[:1].expand(left, -1), feats,
                      feats[-1:].expand(right, -1)], dim=0)


def add_deltas(feats: torch.Tensor,
               opts: DeltaFeaturesOptions = DeltaFeaturesOptions()
               ) -> torch.Tensor:
    """(T, D) → (T, D*(order+1)).  Edge frames are replicated (the
    reference clamps the frame index into [0, T-1])."""
    scales = delta_scales(opts)
    max_off = (len(scales[-1]) - 1) // 2
    T = feats.shape[0]
    padded = _pad_edges(feats, max_off, max_off)
    outs = []
    for s in scales:
        off = (len(s) - 1) // 2
        acc = torch.zeros_like(feats)
        for j, c in enumerate(s):
            if c == 0.0:
                continue
            start = max_off - off + j
            acc = acc + float(c) * padded[start:start + T]
        outs.append(acc)
    return torch.cat(outs, dim=1)


def splice_frames(feats: torch.Tensor, left_context: int,
                  right_context: int) -> torch.Tensor:
    """(T, D) → (T, D*(l+r+1)) with edge replication
    (feature-functions.cc SpliceFrames)."""
    T = feats.shape[0]
    padded = _pad_edges(feats, left_context, right_context)
    return torch.cat([padded[k:k + T]
                      for k in range(left_context + right_context + 1)],
                     dim=1)
