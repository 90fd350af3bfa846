"""Fbank, MFCC, spectrogram and PLP feature computers.

Port of ``FbankOptions`` / ``Fbank``, ``MfccOptions`` / ``Mfcc``,
``SpectrogramOptions`` / ``Spectrogram``, ``PlpOptions`` / ``Plp`` (with
``_equal_loudness``, ``_idft_bases``, ``_durbin`` and
``_lpc_to_cepstrum``), ``compute_dct_matrix`` and
``compute_lifter_coeffs`` from kaldi_tpu/features/compute.py (parity
targets src/feat/feature-fbank.h, feature-mfcc.h,
feature-spectrogram.h, feature-plp.h).  Framing and dither run on the
host (numpy); DC removal, raw log-energy and pre-emphasis run as tensor
ops on the computer's device; window → power spectrum → filters →
floor (→ log) runs in the fused fbank kernel (ops/fbank.py
``CudaFbank``), whose DFT is by products, like the TPU kernel it
replaces.  MFCC is that log-mel through the orthonormal DCT and the
lifter, as tensor products.  The spectrogram is the same kernel with
one filter per DFT bin (the identity), so its output is the floored log
power spectrum.  PLP takes the kernel's linear mel energies (the
floor without the log), then runs the equal-loudness weights, the
cube-root compression, the IDFT product to autocorrelations,
Levinson-Durbin and the LPC → cepstrum recursion as tensor ops (loops
over the LPC order and the cepstra, vectorised over frames), in the
original's sign convention, not the reference binary's.  The energy
column (``use_energy``; the spectrogram's column 0) is the raw
log-energy of each frame before pre-emphasis and windowing; the
original's ``raw_energy`` field is left out, since it computes raw
energy whatever the field says.  ``Fbank``'s ``use_power`` (off: the
magnitude spectrum) and ``use_log_fbank`` (off: linear mel energies)
run inside the kernel; ``Mfcc`` and ``Spectrogram`` always take the log
of the power.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from kaldi_tpu_torch.features.mel import MelBanks, MelBanksOptions
from kaldi_tpu_torch.features.window import (FrameExtractionOptions,
                                             extract_frames,
                                             preprocess_frames)
from kaldi_tpu_torch.ops.fbank import _EPS, CudaFbank


# Copied from kaldi_tpu/features/compute.py compute_dct_matrix.
def compute_dct_matrix(num_rows: int, num_cols: int) -> np.ndarray:
    """Orthonormal DCT-II matrix (matrix-functions.cc ComputeDctMatrix)."""
    n = np.arange(num_cols)
    mat = np.zeros((num_rows, num_cols))
    mat[0, :] = math.sqrt(1.0 / num_cols)
    for k in range(1, num_rows):
        mat[k, :] = math.sqrt(2.0 / num_cols) * np.cos(
            math.pi / num_cols * (n + 0.5) * k)
    return mat.astype(np.float32)


# Copied from kaldi_tpu/features/compute.py compute_lifter_coeffs.
def compute_lifter_coeffs(q: float, dim: int) -> np.ndarray:
    """Cepstral liftering coefficients (feature-functions.cc)."""
    i = np.arange(dim)
    return (1.0 + 0.5 * q * np.sin(math.pi * i / q)).astype(np.float32)


@dataclasses.dataclass
class FbankOptions:
    frame_opts: FrameExtractionOptions = dataclasses.field(
        default_factory=FrameExtractionOptions)
    mel_opts: MelBanksOptions = dataclasses.field(
        default_factory=lambda: MelBanksOptions(num_bins=23))
    use_energy: bool = False
    energy_floor: float = 0.0
    use_log_fbank: bool = True
    use_power: bool = True


@dataclasses.dataclass
class MfccOptions:
    frame_opts: FrameExtractionOptions = dataclasses.field(
        default_factory=FrameExtractionOptions)
    mel_opts: MelBanksOptions = dataclasses.field(
        default_factory=lambda: MelBanksOptions(num_bins=23))
    num_ceps: int = 13
    use_energy: bool = True
    energy_floor: float = 0.0
    cepstral_lifter: float = 22.0


@dataclasses.dataclass
class SpectrogramOptions:
    frame_opts: FrameExtractionOptions = dataclasses.field(
        default_factory=FrameExtractionOptions)
    energy_floor: float = 0.0


@dataclasses.dataclass
class PlpOptions:
    frame_opts: FrameExtractionOptions = dataclasses.field(
        default_factory=FrameExtractionOptions)
    mel_opts: MelBanksOptions = dataclasses.field(
        default_factory=lambda: MelBanksOptions(num_bins=23))
    lpc_order: int = 12
    num_ceps: int = 13
    use_energy: bool = True
    energy_floor: float = 0.0
    compress_factor: float = 1.0 / 3.0
    cepstral_lifter: float = 22.0
    cepstral_scale: float = 1.0


class _LogMelBase:
    """Framing, pre-processing and the fbank kernel, on one device."""

    def __init__(self, opts, dim: int, device: torch.device | str,
                 **kernel):
        self.opts = opts
        self.frame_opts = opts.frame_opts
        self.kernel = CudaFbank(opts.frame_opts,
                                getattr(opts, "mel_opts", None), device,
                                **kernel)
        self.device = self.kernel.device
        self.dim = dim

    def frames(self, waveform: np.ndarray,
               rng: Optional[np.random.Generator] = None) -> np.ndarray:
        return extract_frames(waveform, self.frame_opts, rng)

    def _log_mel(self, frames: torch.Tensor):
        """(F, window_size) raw frames → (mel energies (F, n_mel), as the
        kernel's flags say, log-energy (F,) floored at
        ``energy_floor``)."""
        x, log_energy = preprocess_frames(frames, self.frame_opts)
        if self.opts.energy_floor > 0.0:
            log_energy = torch.clamp_min(log_energy,
                                         math.log(self.opts.energy_floor))
        return self.kernel(x.contiguous()), log_energy

    def compute(self, waveform: np.ndarray,
                rng: Optional[np.random.Generator] = None) -> torch.Tensor:
        """One waveform → (num_frames, dim) float32 on the device."""
        frames = self.frames(waveform, rng)
        if frames.shape[0] == 0:
            return torch.zeros((0, self.dim), dtype=torch.float32,
                               device=self.device)
        return self.compute_frames(torch.from_numpy(frames).to(self.device))


class Fbank(_LogMelBase):
    """Offline fbank computer bound to one device."""

    def __init__(self, opts: FbankOptions = None,
                 device: torch.device | str = "cuda"):
        opts = opts or FbankOptions()
        super().__init__(opts, opts.mel_opts.num_bins
                         + (1 if opts.use_energy else 0), device,
                         use_power=opts.use_power,
                         use_log=opts.use_log_fbank)

    def compute_frames(self, frames: torch.Tensor) -> torch.Tensor:
        """(F, window_size) raw frames on the device → (F, dim)."""
        out, log_energy = self._log_mel(frames)
        if self.opts.use_energy:
            out = torch.cat([log_energy[:, None], out], dim=1)
        return out


class Mfcc(_LogMelBase):
    """Offline MFCC computer bound to one device."""

    def __init__(self, opts: MfccOptions = None,
                 device: torch.device | str = "cuda"):
        opts = opts or MfccOptions()
        super().__init__(opts, opts.num_ceps, device)
        self.dct = torch.from_numpy(np.ascontiguousarray(compute_dct_matrix(
            opts.num_ceps, opts.mel_opts.num_bins).T)).to(self.device)
        self.lifter = None
        if opts.cepstral_lifter != 0.0:
            self.lifter = torch.from_numpy(compute_lifter_coeffs(
                opts.cepstral_lifter, opts.num_ceps)).to(self.device)

    def compute_frames(self, frames: torch.Tensor) -> torch.Tensor:
        """(F, window_size) raw frames on the device → (F, num_ceps)."""
        log_mel, log_energy = self._log_mel(frames)
        ceps = log_mel @ self.dct
        if self.lifter is not None:
            ceps = ceps * self.lifter[None, :]
        if self.opts.use_energy:
            ceps[:, 0] = log_energy
        return ceps


class Spectrogram(_LogMelBase):
    """Offline log power spectrum computer bound to one device: the
    fbank kernel with one filter per DFT bin; column 0 (the DC bin) is
    the floored log-energy."""

    def __init__(self, opts: SpectrogramOptions = None,
                 device: torch.device | str = "cuda"):
        opts = opts or SpectrogramOptions()
        n_bins = opts.frame_opts.padded_window_size // 2 + 1
        super().__init__(opts, n_bins, device,
                         filters=np.eye(n_bins, dtype=np.float32))

    def compute_frames(self, frames: torch.Tensor) -> torch.Tensor:
        """(F, window_size) raw frames on the device → (F, n_fft/2 + 1)."""
        out, log_energy = self._log_mel(frames)
        out[:, 0] = log_energy
        return out


# Copied from kaldi_tpu/features/compute.py _equal_loudness.
def _equal_loudness(center_freqs: np.ndarray) -> np.ndarray:
    """Equal-loudness curve (mel-computations.cc GetEqualLoudnessVector)."""
    fsq = center_freqs.astype(np.float64) ** 2
    fsub = fsq / (fsq + 1.6e5)
    return (fsub * fsub * ((fsq + 1.44e6) / (fsq + 9.61e6))).astype(np.float32)


# Copied from kaldi_tpu/features/compute.py _idft_bases.
def _idft_bases(n_bases: int, dimension: int) -> np.ndarray:
    """feature-functions.cc InitIdftBases."""
    angle = math.pi / (dimension - 1)
    scale = 1.0 / (2.0 * (dimension - 1))
    i = np.arange(n_bases)[:, None].astype(np.float64)
    j = np.arange(dimension)[None, :].astype(np.float64)
    mat = 2.0 * scale * np.cos(angle * i * j)
    mat[:, 0] = scale
    mat[:, -1] = scale * np.cos(angle * i[:, 0] * (dimension - 1))
    return mat.astype(np.float32)


def _durbin(autocorr: torch.Tensor, order: int):
    """Levinson-Durbin over the LPC order, vectorised over frames, in
    the original's convention (matrix-functions.cc Durbin with the
    reflection coefficients' sign as the original keeps it).
    autocorr (F, order + 1) → (lpc (F, order), residual energy (F,))."""
    lpc = autocorr.new_zeros((autocorr.shape[0], order))
    err = autocorr[:, 0]
    # rev[:, order - k] = r[k], so that r[i - j] for j < i is the run
    # rev[:, order - i:order]
    rev = autocorr.flip(1)
    for i in range(order):
        acc = (lpc[:, :i] * rev[:, order - i:order]).sum(dim=1)
        ki = (autocorr[:, i + 1] - acc) / torch.clamp_min(err, _EPS)
        # a'_j = a_j - ki * a_{i-1-j} for j < i
        lpc[:, :i] -= ki[:, None] * lpc[:, :i].flip(1)
        lpc[:, i] = ki
        err = err * (1.0 - ki * ki)
    return lpc, err


def _lpc_to_cepstrum(lpc: torch.Tensor, order: int,
                     num_ceps: int) -> torch.Tensor:
    """LPC → cepstrum recursion (matrix-functions.cc Lpc2Cepstrum),
    vectorised over frames: c_i = a_i + (1/i) Σ_{j=max(1, i-order)}^{i-1}
    j · c_j · a_{i-j}, with a_i = 0 past ``order`` (1-based indices)."""
    ceps = lpc.new_zeros((lpc.shape[0], num_ceps))
    # rev[:, order - 1 - k] = a_{k+1}, so that a_{i-j} for j = j0..i-1 is
    # the run rev[:, order - i + j0:order]
    rev = lpc.flip(1)
    for i in range(1, num_ceps + 1):
        val = lpc[:, i - 1] if i <= order else lpc.new_zeros(lpc.shape[0])
        j0 = max(1, i - order)
        if j0 < i:
            j = torch.arange(j0, i, dtype=lpc.dtype, device=lpc.device)
            acc = (j * ceps[:, j0 - 1:i - 1]
                   * rev[:, order - i + j0:order]).sum(dim=1)
            val = val + acc / i
        ceps[:, i - 1] = val
    return ceps


class Plp(_LogMelBase):
    """Offline PLP computer bound to one device."""

    def __init__(self, opts: PlpOptions = None,
                 device: torch.device | str = "cuda"):
        opts = opts or PlpOptions()
        super().__init__(opts, opts.num_ceps, device, use_log=False)
        mel = MelBanks(opts.mel_opts, opts.frame_opts)

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        self.equal_loudness = dev(_equal_loudness(mel.center_freqs))
        self.idft = dev(_idft_bases(opts.lpc_order + 1,
                                    opts.mel_opts.num_bins + 2).T)
        self.lifter = None
        if opts.cepstral_lifter != 0.0:
            self.lifter = dev(compute_lifter_coeffs(opts.cepstral_lifter,
                                                    opts.num_ceps))

    def compute_frames(self, frames: torch.Tensor) -> torch.Tensor:
        """(F, window_size) raw frames on the device → (F, num_ceps)."""
        return self.from_mel(*self._log_mel(frames))

    def from_mel(self, mel_e: torch.Tensor,
                 log_energy: torch.Tensor) -> torch.Tensor:
        """Floored linear mel energies (F, num_bins) and the frames'
        floored log-energy (F,) → PLP (F, num_ceps)."""
        o = self.opts
        mel_e = (mel_e * self.equal_loudness[None, :]) ** o.compress_factor
        # duplicate the first and last bins (feature-plp.cc)
        dup = torch.cat([mel_e[:, :1], mel_e, mel_e[:, -1:]], dim=1)
        lpc, resid = _durbin(dup @ self.idft, o.lpc_order)
        ceps = _lpc_to_cepstrum(lpc, o.lpc_order, o.num_ceps)
        c0 = torch.log(torch.clamp_min(resid, _EPS))
        out = torch.cat([c0[:, None], ceps[:, :o.num_ceps - 1]], dim=1)
        if self.lifter is not None:
            out = out * self.lifter[None, :]
        if o.cepstral_scale != 1.0:
            out = out * o.cepstral_scale
        if o.use_energy:
            out[:, 0] = log_energy
        return out
