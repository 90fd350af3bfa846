# Copied from kaldi_tpu/features/pitch.py; imports rewritten to
# kaldi_tpu_torch.
"""Pitch extraction.

Parity target: src/feat/pitch-functions.h (ComputeKaldiPitch — the
Kaldi pitch tracker of Ghahremani et al. 2014: lowpass + resample the
waveform to 4 kHz, NCCF over candidate lags with an energy-scaled
ballast term, Viterbi smoothing of the lag track with a log-lag
transition cost, POV (probability-of-voicing) and pitch outputs;
ProcessPitch post-processing into paste-able features).

Structure matches the reference two-stage design: the NCCF runs on the
`resample_freq` (4 kHz) signal, is computed twice (ballasted for the
Viterbi lag search, ballast-free for the POV feature), and sub-integer
lag resolution comes from interpolating the NCCF around the chosen
peak (the reference upsamples the NCCF with ArbitraryResample; a
parabola through the peak and neighbours is the closed-form
equivalent).  The NCCF batch is one FFT cross-correlation over all
frames — no per-lag loops.  Pitch is far off the hot path (it feeds
feature pasting, not the decoder), so this stays host-side numpy.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from kaldi_tpu_torch.core.logging import get_logger
from kaldi_tpu_torch.features.resample import linear_resample

log = get_logger(__name__)


@dataclasses.dataclass
class PitchExtractionOptions:
    samp_freq: float = 16000.0
    frame_shift_ms: float = 10.0
    frame_length_ms: float = 25.0
    min_f0: float = 50.0
    max_f0: float = 400.0
    penalty_factor: float = 0.1
    nccf_ballast: float = 7000.0
    soft_min_f0: float = 10.0
    resample_freq: float = 4000.0
    lowpass_cutoff: float = 1000.0


def _nccf(wave: np.ndarray, shift: int, length: int, min_lag: int,
          max_lag: int, ballast: float):
    """Batched NCCF.  Returns (nccf_ballasted, nccf_pov), each
    (T, max_lag - min_lag + 1).

    inner[t, lag] = x_t . y_t(lag) with x_t = wave[s:s+length] and
    y_t(lag) = wave[s+lag:s+lag+length]; computed for all lags of all
    frames as one rfft cross-correlation of the zero-padded frame
    window against its first `length` samples.
    """
    win = length + max_lag
    T = max(0, (len(wave) - win) // shift + 1)
    if T == 0:
        z = np.zeros((0, max_lag - min_lag + 1))
        return z, z
    idx = np.arange(T)[:, None] * shift + np.arange(win)[None, :]
    W = wave[idx]                               # (T, win)
    X = W[:, :length]                           # (T, length)
    nfft = 1 << int(math.ceil(math.log2(win + length)))
    # c[t, lag] = sum_j X[t, j] * W[t, j + lag]  for lag in [0, max_lag]
    c = np.fft.irfft(np.fft.rfft(W, nfft) * np.conj(np.fft.rfft(X, nfft)),
                     nfft)[:, :max_lag + 1]
    e1 = np.einsum("tj,tj->t", X, X)            # (T,)
    # e2[t, lag] = sum_j W[t, j+lag]^2 — sliding energy via cumsum
    csq = np.concatenate(
        [np.zeros((T, 1)), np.cumsum(W * W, axis=1)], axis=1)
    lags_all = np.arange(max_lag + 1)
    e2 = csq[:, lags_all + length] - csq[:, lags_all]
    inner = c[:, min_lag:max_lag + 1]
    e2 = e2[:, min_lag:max_lag + 1]
    denom = np.sqrt(np.maximum(e1[:, None] * e2, 0.0))
    nccf_b = inner / np.maximum(np.sqrt(e1[:, None] * e2 + ballast), 1e-20)
    nccf_pov = inner / np.maximum(denom, 1e-20)
    return nccf_b, nccf_pov


def compute_kaldi_pitch(wave: np.ndarray,
                        opts: PitchExtractionOptions = None) -> np.ndarray:
    """→ (num_frames, 2): [pov_feature, pitch_hz] per frame.

    Frame count follows the input rate's framing (snip-edges over the
    NCCF outer window), as in the reference where downstream features
    are pasted frame-for-frame with MFCCs.
    """
    o = opts or PitchExtractionOptions()
    sf = float(o.samp_freq)
    wave = np.asarray(wave, np.float64)

    # stage 1: lowpass + resample to the pitch-analysis rate
    rf = min(float(o.resample_freq), sf)
    if rf < sf:
        ds = linear_resample(wave, sf, rf, num_zeros=6,
                             filter_cutoff=min(o.lowpass_cutoff,
                                               0.49 * rf)).astype(np.float64)
    else:
        ds = wave
    shift = int(rf * o.frame_shift_ms / 1000)
    length = int(rf * o.frame_length_ms / 1000)
    min_lag = max(2, int(rf / o.max_f0))
    max_lag = int(math.ceil(rf / o.min_f0))

    # ballast relative to the signal's own energy (the reference scales
    # by mean-square energy so quiet frames read as unvoiced regardless
    # of absolute amplitude units)
    msq = float(np.mean(ds ** 2)) + 1e-20
    ballast = (o.nccf_ballast / 7000.0) * (msq * length) ** 2
    nccf, nccf_pov = _nccf(ds, shift, length, min_lag, max_lag, ballast)
    T, L = nccf.shape
    if T == 0:
        return np.zeros((0, 2), np.float32)

    # stage 2: Viterbi over lag candidates — reward NCCF, penalize
    # log-lag jumps (penalty_factor), small short-lag preference
    # (soft_min_f0 role) to break octave ties toward the true F0
    lags = np.arange(min_lag, max_lag + 1).astype(np.float64)
    loglag = np.log(lags)
    octave_bias = 0.02 * (loglag - loglag[0])
    trans = o.penalty_factor * (loglag[None, :] - loglag[:, None]) ** 2
    cost = np.empty((T, L))
    back = np.zeros((T, L), np.int32)
    cost[0] = -nccf[0] + octave_bias
    for t in range(1, T):
        total = cost[t - 1][:, None] + trans
        back[t] = np.argmin(total, axis=0)
        cost[t] = total[back[t], np.arange(L)] - nccf[t] + octave_bias
    path = np.zeros(T, np.int32)
    path[-1] = int(np.argmin(cost[-1]))
    for t in range(T - 2, -1, -1):
        path[t] = back[t + 1, path[t + 1]]

    i = path
    rows = np.arange(T)
    c1 = np.clip(nccf_pov[rows, i], -1.0, 1.0)
    # POV feature (pitch-functions.cc NccfToPovFeature shape)
    pov = 2.0 / (1.0 + np.exp(-10.0 * (c1 - 0.5))) - 1.0
    # sub-sample lag via parabolic interpolation of the NCCF peak
    lag = lags[i].copy()
    interior = (i > 0) & (i < L - 1)
    c0 = nccf_pov[rows, np.maximum(i - 1, 0)]
    c2 = nccf_pov[rows, np.minimum(i + 1, L - 1)]
    denom = c0 - 2.0 * np.clip(nccf_pov[rows, i], -1.0, 1.0) + c2
    ok = interior & (denom < -1e-12)
    delta = np.where(ok, 0.5 * (c0 - c2) / np.where(ok, denom, 1.0), 0.0)
    lag += np.clip(delta, -0.5, 0.5)
    pitch_hz = rf / lag

    out = np.stack([pov, pitch_hz], axis=1).astype(np.float32)

    # match the input-rate frame count (paste-ability with MFCC/fbank
    # computed at samp_freq): pad/trim by edge-repeat
    shift_in = int(sf * o.frame_shift_ms / 1000)
    length_in = int(sf * o.frame_length_ms / 1000)
    T_in = max(0, (len(wave) - length_in) // shift_in + 1)
    if T_in > T:
        out = np.concatenate([out, np.repeat(out[-1:], T_in - T, axis=0)])
    elif T_in < T:
        out = out[:T_in]
    return out


def process_pitch(pitch: np.ndarray, pov_scale: float = 2.0,
                  pitch_scale: float = 2.0, delta_scale: float = 10.0,
                  normalization_window: int = 151) -> np.ndarray:
    """(T, 2) [pov_feature, pitch_hz] → (T, 3) processed features
    [pov, normalized-log-pitch, delta-pitch], the ProcessPitch /
    paste-able add-pitch feature layout (pitch-functions.cc
    ProcessPitchOptions defaults: POV-weighted sliding-window mean
    subtraction of log-pitch, scaled delta)."""
    T = pitch.shape[0]
    if T == 0:
        return np.zeros((0, 3), np.float32)
    pov = pitch[:, 0].astype(np.float64)
    logp = np.log(np.maximum(pitch[:, 1].astype(np.float64), 1e-10))
    # POV weights in [0,1] for the weighted running mean
    w = np.clip((pov + 1.0) / 2.0, 1e-3, 1.0)
    half = normalization_window // 2
    norm = np.empty(T)
    csw = np.concatenate([[0.0], np.cumsum(w)])
    cswp = np.concatenate([[0.0], np.cumsum(w * logp)])
    for t in range(T):
        lo, hi = max(0, t - half), min(T, t + half + 1)
        norm[t] = (cswp[hi] - cswp[lo]) / (csw[hi] - csw[lo])
    normalized = logp - norm
    delta = np.zeros(T)
    if T > 1:
        delta[1:] = logp[1:] - logp[:-1]
        delta[0] = delta[1]
    out = np.stack([pov_scale * pov, pitch_scale * normalized,
                    delta_scale * delta], axis=1)
    return out.astype(np.float32)
