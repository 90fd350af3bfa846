"""Post-processing: deltas, splicing, sliding-window CMN.

Port of ``DeltaFeaturesOptions``, ``delta_scales``, ``add_deltas``,
``splice_frames``, ``SlidingWindowCmnOptions`` and
``sliding_window_cmn`` from kaldi_tpu/features/functions.py (parity
targets src/feat/feature-functions.h DeltaFeatures, SpliceFrames,
src/featbin/apply-cmvn-sliding.cc).  Deltas and splicing are shifted
slices of the edge-replicated utterance on the features' device, summed
in the original's order so that float32 results agree to rounding.
Sliding-window CMN is host numpy, numpy in and numpy out, as in the
original (data preparation, not the decode path).
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


# Copied from kaldi_tpu/features/functions.py SlidingWindowCmnOptions.
@dataclasses.dataclass
class SlidingWindowCmnOptions:
    cmn_window: int = 600
    min_window: int = 100
    normalize_variance: bool = False
    center: bool = True


# Copied from kaldi_tpu/features/functions.py sliding_window_cmn.
def sliding_window_cmn(feats: np.ndarray,
                       opts: SlidingWindowCmnOptions = SlidingWindowCmnOptions()
                       ) -> np.ndarray:
    """Per-frame mean (and optionally variance) normalization over a
    sliding window (slide-cmn semantics with center=true).  Host-side
    numpy: used in data prep, not the decode hot path."""
    feats = np.asarray(feats, dtype=np.float64)
    T, D = feats.shape
    out = np.empty_like(feats)
    for t in range(T):
        if opts.center:
            lo = t - opts.cmn_window // 2
            hi = lo + opts.cmn_window
            if lo < 0:
                lo, hi = 0, min(opts.cmn_window, T)
            if hi > T:
                hi = T
                lo = max(0, T - opts.cmn_window)
        else:
            lo = max(0, t + 1 - opts.cmn_window)
            hi = max(t + 1, min(opts.min_window, T))
        window = feats[lo:hi]
        mean = window.mean(axis=0)
        out[t] = feats[t] - mean
        if opts.normalize_variance:
            var = np.maximum(window.var(axis=0), 1e-10)
            out[t] /= np.sqrt(var)
    return out.astype(np.float32)
