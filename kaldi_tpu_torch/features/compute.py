"""Fbank and MFCC feature computers.

Port of ``FbankOptions`` / ``Fbank`` and ``MfccOptions`` / ``Mfcc``,
``compute_dct_matrix`` and ``compute_lifter_coeffs`` from
kaldi_tpu/features/compute.py (parity targets src/feat/feature-fbank.h,
feature-mfcc.h).  Framing and dither run on the host (numpy); DC
removal, raw log-energy and pre-emphasis run as tensor ops on the
computer's device; window → power spectrum → mel → log runs in the
fused fbank kernel (ops/fbank.py ``CudaFbank``), whose DFT is by
products, like the TPU kernel it replaces.  MFCC is that log-mel
through the orthonormal DCT and the lifter, as tensor products.  The
energy column (``use_energy``) is the raw log-energy of each frame
before pre-emphasis and windowing; the original's ``raw_energy`` field
is left out, since it computes raw energy whatever the field says.
``Fbank``'s ``use_power`` (off: the magnitude spectrum) and
``use_log_fbank`` (off: linear mel energies) run inside the kernel;
``Mfcc`` always takes the log of the power.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from kaldi_tpu_torch.features.mel import MelBanksOptions
from kaldi_tpu_torch.features.window import (FrameExtractionOptions,
                                             extract_frames,
                                             preprocess_frames)
from kaldi_tpu_torch.ops.fbank import CudaFbank


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


class _LogMelBase:
    """Framing, pre-processing and the fbank kernel, on one device."""

    def __init__(self, opts, dim: int, device: torch.device | str,
                 **spectrum):
        self.opts = opts
        self.frame_opts = opts.frame_opts
        self.kernel = CudaFbank(opts.frame_opts, opts.mel_opts, device,
                                **spectrum)
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
