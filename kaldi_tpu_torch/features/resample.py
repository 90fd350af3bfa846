# Copied from kaldi_tpu/features/resample.py; imports rewritten to
# kaldi_tpu_torch.
"""Waveform resampling.

Parity target: src/feat/resample.h (LinearResample — windowed-sinc
arbitrary-rate resampling).  Implemented as one dense filter matrix
application per output block; for the standard rate pairs this is a
small matmul, device-friendly if needed (host numpy here — data prep).
"""

from __future__ import annotations

import math

import numpy as np

from kaldi_tpu_torch.core.logging import KaldiError


def linear_resample(wave: np.ndarray, samp_in: float, samp_out: float,
                    num_zeros: int = 6,
                    filter_cutoff: float = 0.0) -> np.ndarray:
    if samp_in == samp_out:
        return np.asarray(wave, np.float32)
    if filter_cutoff <= 0.0:
        filter_cutoff = 0.99 * 0.5 * min(samp_in, samp_out)
    if filter_cutoff * 2 > min(samp_in, samp_out):
        raise KaldiError("filter cutoff above Nyquist")
    wave = np.asarray(wave, np.float64)
    n_in = len(wave)
    n_out = int(math.floor(n_in * samp_out / samp_in))
    window_width = num_zeros / (2.0 * filter_cutoff)

    if samp_in % samp_out == 0:
        # integer decimation fast path: every output time lands exactly
        # on the input grid, so the windowed-sinc taps are one fixed FIR
        # filter — a single correlation instead of a per-sample loop
        step = int(samp_in // samp_out)
        half = int(math.floor(window_width * samp_in))
        dt = np.arange(-half, half + 1) / samp_in
        win = np.where(np.abs(dt) <= window_width,
                       0.5 + 0.5 * np.cos(math.pi * dt / window_width), 0.0)
        f = 2 * filter_cutoff / samp_in * win * np.sinc(2 * filter_cutoff * dt)
        padded = np.concatenate([np.zeros(half), wave, np.zeros(half)])
        full = np.convolve(padded, f[::-1], mode="valid")
        return full[:n_out * step:step].astype(np.float32)

    out = np.zeros(n_out)
    in_times = np.arange(n_in) / samp_in
    for n in range(n_out):
        t = n / samp_out
        lo = max(0, int(math.ceil((t - window_width) * samp_in)))
        hi = min(n_in - 1, int(math.floor((t + window_width) * samp_in)))
        if hi < lo:
            continue
        dt = in_times[lo:hi + 1] - t
        # raised-cosine (Hann) windowed sinc
        win = 0.5 + 0.5 * np.cos(math.pi * dt / window_width)
        win = np.where(np.abs(dt) <= window_width, win, 0.0)
        x = 2 * filter_cutoff * dt
        sinc = np.sinc(x)   # sin(πx)/(πx) with the x=0 case handled
        f = 2 * filter_cutoff / samp_in * win * sinc
        out[n] = np.dot(f, wave[lo:hi + 1])
    return out.astype(np.float32)
