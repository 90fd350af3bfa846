"""Mel filterbank construction (numpy).

Port of kaldi_tpu/features/mel.py (parity target
src/feat/mel-computations.h).  The bank is a dense
(num_bins, num_fft_bins + 1) matrix, the layout the fbank kernel's mel
product reads.  Identical arithmetic to the original, so the matrices
are equal bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from kaldi_tpu_torch.core.logging import KaldiError
from kaldi_tpu_torch.features.window import FrameExtractionOptions


@dataclasses.dataclass
class MelBanksOptions:
    num_bins: int = 23
    low_freq: float = 20.0
    high_freq: float = 0.0   # <= 0 means nyquist + high_freq
    vtln_low: float = 100.0
    vtln_high: float = -500.0


def mel_scale(freq):
    return 1127.0 * np.log(1.0 + np.asarray(freq) / 700.0)


def inverse_mel_scale(mel):
    return 700.0 * (np.exp(np.asarray(mel) / 1127.0) - 1.0)


def vtln_warp_freq(vtln_low_cutoff, vtln_high_cutoff, low_freq, high_freq,
                   warp_factor, freq):
    """Piecewise-linear VTLN warp (mel-computations.cc VtlnWarpFreq)."""
    if freq < low_freq or freq > high_freq:
        return freq
    l = vtln_low_cutoff * max(1.0, warp_factor)
    h = vtln_high_cutoff * min(1.0, warp_factor)
    scale = 1.0 / warp_factor
    Fl = scale * l
    Fh = scale * h
    scale_left = (Fl - low_freq) / (l - low_freq)
    scale_right = (high_freq - Fh) / (high_freq - h)
    if freq < l:
        return low_freq + scale_left * (freq - low_freq)
    elif freq < h:
        return scale * freq
    else:
        return high_freq + scale_right * (freq - high_freq)


class MelBanks:
    """Dense mel filterbank matrix + center frequencies."""

    def __init__(self, opts: MelBanksOptions,
                 frame_opts: FrameExtractionOptions,
                 vtln_warp_factor: float = 1.0):
        num_bins = opts.num_bins
        if num_bins < 3:
            raise KaldiError("Must have at least 3 mel bins")
        sample_freq = frame_opts.samp_freq
        window_length_padded = frame_opts.padded_window_size
        num_fft_bins = window_length_padded // 2
        nyquist = 0.5 * sample_freq
        low_freq = opts.low_freq
        high_freq = (opts.high_freq if opts.high_freq > 0.0
                     else nyquist + opts.high_freq)
        if not (0.0 <= low_freq < nyquist and 0.0 < high_freq <= nyquist
                and low_freq < high_freq):
            raise KaldiError(f"Bad frequency range [{low_freq}, {high_freq}]")

        fft_bin_width = sample_freq / window_length_padded
        mel_low = float(mel_scale(low_freq))
        mel_high = float(mel_scale(high_freq))
        mel_delta = (mel_high - mel_low) / (num_bins + 1)

        vtln_low = opts.vtln_low
        vtln_high = opts.vtln_high
        if vtln_high < 0.0:
            vtln_high += nyquist

        bins = np.zeros((num_bins, num_fft_bins + 1), dtype=np.float32)
        center_freqs = np.zeros(num_bins, dtype=np.float32)
        fft_freqs = fft_bin_width * np.arange(num_fft_bins + 1)
        mel_fft = mel_scale(fft_freqs)

        for b in range(num_bins):
            left_mel = mel_low + b * mel_delta
            center_mel = mel_low + (b + 1) * mel_delta
            right_mel = mel_low + (b + 2) * mel_delta
            if vtln_warp_factor != 1.0:
                def warp(m):
                    f = float(inverse_mel_scale(m))
                    return float(mel_scale(vtln_warp_freq(
                        vtln_low, vtln_high, low_freq, high_freq,
                        vtln_warp_factor, f)))
                left_mel, center_mel, right_mel = (
                    warp(left_mel), warp(center_mel), warp(right_mel))
            center_freqs[b] = inverse_mel_scale(center_mel)
            up = (mel_fft - left_mel) / (center_mel - left_mel)
            down = (right_mel - mel_fft) / (right_mel - center_mel)
            weight = np.minimum(up, down)
            bins[b] = np.maximum(0.0, weight).astype(np.float32)

        self.bins = bins                      # (num_bins, num_fft_bins+1)
        self.center_freqs = center_freqs
        self.opts = opts

    @property
    def matrix(self) -> np.ndarray:
        """(num_bins, num_fft_bins+1) float32 — multiply with power spectrum."""
        return self.bins
