"""Online (streaming) feature extraction.

Port of kaldi_tpu/features/online.py (parity targets
src/feat/online-feature.h OnlineMfcc/OnlineFbank, OnlineCmvn,
OnlineDeltaFeature, OnlineSpliceFrames, and
src/online2/online-nnet2-feature-pipeline.h).  The pipeline accepts
waveform chunks of any size and exposes frames as they become
computable:

  * a frame is ready once its full window of samples has arrived; each
    chunk that completes frames runs the computer (``Fbank`` or ``Mfcc``,
    so the fbank kernel on a CUDA device) once over the new samples, and
    the new frames are appended on the device with one ``torch.cat``;
  * online CMVN subtracts the mean of a sliding window of seen frames,
    padded up to the window from frozen global stats; the window sums
    come from float64 prefix sums on the device (a few launches per
    call, where the original loops over frames on the host);
  * deltas and splicing need future context, so the ready-frame count
    lags by the right context.

Online i-vectors (``ivector_estimator``) wait for the port of
am/ivector.py: passing one raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from kaldi_tpu_torch.core.logging import KaldiError
from kaldi_tpu_torch.features.compute import Mfcc, MfccOptions
from kaldi_tpu_torch.features.functions import (DeltaFeaturesOptions,
                                                add_deltas, splice_frames)
from kaldi_tpu_torch.features.window import num_frames as calc_num_frames


# Copied from kaldi_tpu/features/online.py OnlineCmvnOptions.
@dataclasses.dataclass
class OnlineCmvnOptions:
    cmn_window: int = 600
    normalize_variance: bool = False
    # global stats (2, D+1) from training data; required here (the
    # reference can also run without, using speaker stats)
    global_stats: Optional[np.ndarray] = None


def online_cmvn(feats: torch.Tensor, o: OnlineCmvnOptions) -> torch.Tensor:
    """(T, D) → each frame minus the mean of the last ``cmn_window``
    frames up to it, the window padded with the global mean while fewer
    frames have been seen (OnlineCmvn with global fallback)."""
    T, D = feats.shape
    x = feats.to(torch.float64)
    cs = torch.cat([x.new_zeros((1, D)), x.cumsum(0)])
    t = torch.arange(T, device=feats.device)
    lo = (t + 1 - o.cmn_window).clamp_min(0)
    s = cs[t + 1] - cs[lo]
    count = (t + 1 - lo).to(torch.float64)[:, None]
    if o.global_stats is not None:
        g = torch.as_tensor(np.asarray(o.global_stats, np.float64),
                            device=feats.device)
        need = o.cmn_window - count
        short = need > 0
        s = torch.where(short, s + g[0, :D] * (need / g[0, D]), s)
        count = torch.where(short, float(o.cmn_window), count)
    return (x - s / count).to(torch.float32)


class OnlineFeaturePipeline:
    """waveform chunks → base features (+CMVN, deltas or splicing), as
    float32 tensors on the computer's device."""

    def __init__(self, computer, cmvn: Optional[OnlineCmvnOptions] = None,
                 deltas: Optional[DeltaFeaturesOptions] = None,
                 splice: Optional[tuple] = None,
                 ivector_estimator=None, ivector_period: int = 10):
        if ivector_estimator is not None:
            raise KaldiError("OnlineFeaturePipeline: online i-vectors are "
                             "not ported yet (am/ivector.py)")
        if deltas is not None and splice is not None:
            raise KaldiError("use deltas or splicing, not both")
        self.computer = computer
        self.cmvn = cmvn
        self.delta_opts = deltas
        self.splice_ctx = splice
        self._wave = np.zeros(0, np.float32)
        # raw computed frames, on the device
        self._frames = torch.zeros((0, computer.dim), dtype=torch.float32,
                                   device=computer.device)
        self._input_finished = False

    # -- input -------------------------------------------------------------
    def accept_waveform(self, samples: np.ndarray) -> None:
        if self._input_finished:
            raise KaldiError("accept_waveform after input_finished")
        self._wave = np.concatenate([self._wave,
                                     np.asarray(samples, np.float32)])
        self._compute_ready()

    def input_finished(self) -> None:
        self._input_finished = True
        self._compute_ready()

    def _compute_ready(self) -> None:
        opts = self.computer.frame_opts
        total = calc_num_frames(len(self._wave), opts)
        have = self._frames.shape[0]
        if total > have:
            # frame f needs samples up to f*shift + window: compute the
            # new frames from the first sample of the first of them
            feats = self.computer.compute(
                self._wave[have * opts.window_shift:])
            self._frames = torch.cat([self._frames, feats[:total - have]])

    # -- output ------------------------------------------------------------
    @property
    def right_context(self) -> int:
        if self.delta_opts is not None:
            return self.delta_opts.order * self.delta_opts.window
        if self.splice_ctx is not None:
            return self.splice_ctx[1]
        return 0

    def num_frames_ready(self) -> int:
        n = self._frames.shape[0]
        if self._input_finished:
            return n
        return max(0, n - self.right_context)

    def get_frames(self, begin: int, end: int) -> torch.Tensor:
        """Frames [begin, end) of the FINAL feature stream."""
        if end > self.num_frames_ready():
            raise KaldiError("frames not ready")
        out = self._frames
        if self.cmvn is not None:
            out = online_cmvn(out, self.cmvn)
        if self.delta_opts is not None:
            out = add_deltas(out, self.delta_opts)
        elif self.splice_ctx is not None:
            out = splice_frames(out, *self.splice_ctx)
        return out[begin:end]


def make_online_mfcc_pipeline(opts: MfccOptions = None,
                              cmvn_stats: Optional[np.ndarray] = None,
                              deltas: bool = True,
                              device: torch.device | str = "cuda"
                              ) -> OnlineFeaturePipeline:
    """MFCC (+ online CMVN from ``cmvn_stats``) (+ Δ+ΔΔ) on ``device``."""
    computer = Mfcc(opts or MfccOptions(), device=device)
    cmvn = OnlineCmvnOptions(global_stats=cmvn_stats) \
        if cmvn_stats is not None else None
    return OnlineFeaturePipeline(
        computer, cmvn=cmvn,
        deltas=DeltaFeaturesOptions() if deltas else None)
