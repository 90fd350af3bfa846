"""Fused log-mel fbank: the CUDA kernel's wrapper and its plain version.

Port of kaldi_tpu/ops/pallas_frontend.py.  ``CudaFbank`` holds the
constant tables (window, DFT cos/sin, mel) on one device.  Called on a
CUDA tensor it launches ``kt_fbank_logmel`` (csrc/fbank.cu) on the
current stream; called on a CPU tensor it runs ``fbank_reference``, the
same math as PyTorch products.  There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from kaldi_tpu_torch.features.mel import MelBanks, MelBanksOptions
from kaldi_tpu_torch.ops import build
from kaldi_tpu_torch.features.window import (FrameExtractionOptions,
                                             feature_window_function)

_EPS = float(np.finfo(np.float32).tiny)


def dft_matrices(n_fft: int, n_bins: int):
    """(n_fft, n_bins) float32 cos and sin tables of the real DFT
    (``_dft_matrices`` of the original)."""
    k = np.arange(n_fft)[:, None]
    f = np.arange(n_bins)[None, :]
    ang = -2.0 * math.pi * k * f / n_fft
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def fbank_reference(frames: torch.Tensor, window: torch.Tensor,
                    cosm: torch.Tensor, sinm: torch.Tensor,
                    mel: torch.Tensor, logfloor: float = _EPS
                    ) -> torch.Tensor:
    """Plain PyTorch version of the kernel (``fbank_xla`` of the
    original): log(max(((f·w)·C)² + ((f·w)·S)²) · Mel, floor))."""
    fw = frames * window[None, :]
    re = fw @ cosm
    im = fw @ sinm
    power = re * re + im * im
    return torch.log(torch.clamp_min(power @ mel, logfloor))


def _load():
    lib = build.load_library("kt_fbank", build.KERNELS["kt_fbank"])
    fn = lib.kt_fbank_logmel
    if fn.argtypes is None:
        # pointers and the stream as c_void_p: undeclared, ctypes would
        # pass each Python int as a 32-bit int and cut the address
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
    return fn


class CudaFbank:
    """Log-mel fbank of pre-processed frames (N, window_size) float32
    → (N, num_bins).  ``launches`` counts kernel launches."""

    def __init__(self, frame_opts: FrameExtractionOptions = None,
                 mel_opts: MelBanksOptions = None,
                 device: torch.device | str = "cpu"):
        fo = frame_opts or FrameExtractionOptions()
        mo = mel_opts or MelBanksOptions()
        self.device = torch.device(device)
        self.win_size = fo.window_size
        n_fft = fo.padded_window_size
        self.n_bins = n_fft // 2 + 1
        # frames are zero-padded from window_size to n_fft, so only the
        # first window_size rows of the DFT tables ever multiply data
        cosm, sinm = dft_matrices(n_fft, self.n_bins)
        mel = MelBanks(mo, fo).matrix.T                 # (n_bins, n_mel)
        self.n_mel = mel.shape[1]

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        self.window = dev(feature_window_function(fo))
        self.cos = dev(cosm[:self.win_size])
        self.sin = dev(sinm[:self.win_size])
        self.mel = dev(mel)
        # "cuda" → "cuda:<current>", so that it compares equal to the
        # device of a tensor moved there
        self.device = self.mel.device
        self.launches = 0

    def __call__(self, frames: torch.Tensor) -> torch.Tensor:
        if frames.dim() != 2 or frames.shape[1] != self.win_size:
            raise ValueError(f"frames must be (N, {self.win_size}), got "
                             f"{tuple(frames.shape)}")
        if frames.dtype != torch.float32:
            raise TypeError(f"frames must be float32, got {frames.dtype}")
        if frames.device != self.device:
            raise ValueError(f"frames on {frames.device}, tables on "
                             f"{self.device}")
        if frames.device.type == "cpu":
            return fbank_reference(frames, self.window, self.cos, self.sin,
                                   self.mel)
        if frames.device.type != "cuda":
            raise ValueError(f"unsupported device {frames.device}")
        if not frames.is_contiguous():
            raise ValueError("frames must be contiguous")
        fn = _load()
        n = frames.shape[0]
        out = torch.empty((n, self.n_mel), dtype=torch.float32,
                          device=frames.device)
        stream = torch.cuda.current_stream(frames.device).cuda_stream
        rc = fn(frames.data_ptr(), self.window.data_ptr(),
                self.cos.data_ptr(), self.sin.data_ptr(),
                self.mel.data_ptr(), out.data_ptr(),
                n, self.win_size, self.n_bins, self.n_mel, stream)
        if rc != 0:
            raise RuntimeError(f"kt_fbank_logmel failed: cudaError {rc}")
        self.launches += 1
        return out
