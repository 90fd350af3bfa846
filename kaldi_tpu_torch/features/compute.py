"""Fbank feature computer.

Port of ``FbankOptions`` / ``Fbank`` from kaldi_tpu/features/compute.py
(parity target src/feat/feature-fbank.h).  Framing and dither run on
the host (numpy); DC removal, raw log-energy and pre-emphasis run as
tensor ops on the computer's device; window → power spectrum → mel →
log runs in the fused fbank kernel (ops/fbank.py ``CudaFbank``), whose
DFT is by products, like the TPU kernel it replaces.  The kernel
computes log power-mel, and the energy column (``use_energy``) is the
raw log-energy of each frame before pre-emphasis and windowing.
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


@dataclasses.dataclass
class FbankOptions:
    frame_opts: FrameExtractionOptions = dataclasses.field(
        default_factory=FrameExtractionOptions)
    mel_opts: MelBanksOptions = dataclasses.field(
        default_factory=lambda: MelBanksOptions(num_bins=23))
    use_energy: bool = False
    energy_floor: float = 0.0


class Fbank:
    """Offline fbank computer bound to one device."""

    def __init__(self, opts: FbankOptions = None,
                 device: torch.device | str = "cpu"):
        opts = opts or FbankOptions()
        self.opts = opts
        self.frame_opts = opts.frame_opts
        self.device = torch.device(device)
        self.kernel = CudaFbank(opts.frame_opts, opts.mel_opts, self.device)
        self.dim = opts.mel_opts.num_bins + (1 if opts.use_energy else 0)

    def frames(self, waveform: np.ndarray,
               rng: Optional[np.random.Generator] = None) -> np.ndarray:
        return extract_frames(waveform, self.frame_opts, rng)

    def compute_frames(self, frames: torch.Tensor) -> torch.Tensor:
        """(F, window_size) raw frames on the device → (F, dim)."""
        x, log_energy = preprocess_frames(frames, self.frame_opts)
        out = self.kernel(x.contiguous())
        if self.opts.use_energy:
            if self.opts.energy_floor > 0.0:
                log_energy = torch.clamp_min(
                    log_energy, math.log(self.opts.energy_floor))
            out = torch.cat([log_energy[:, None], out], dim=1)
        return out

    def compute(self, waveform: np.ndarray,
                rng: Optional[np.random.Generator] = None) -> torch.Tensor:
        """One waveform → (num_frames, dim) float32 on the device."""
        frames = self.frames(waveform, rng)
        if frames.shape[0] == 0:
            return torch.zeros((0, self.dim), dtype=torch.float32,
                               device=self.device)
        return self.compute_frames(torch.from_numpy(frames).to(self.device))
