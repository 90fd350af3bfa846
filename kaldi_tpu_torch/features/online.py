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
    lags by the right context;
  * with an ``ivector_estimator`` (am/ivector.py
    ``OnlineIvectorEstimator``, float64 on its extractor's device) the
    raw pre-CMVN frames go to the estimator at every ``ivector_period``
    boundary, the estimate there is kept per block, and ``get_frames``
    appends each frame's block estimate (the current one past the last
    complete block) as float32 columns on the device.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

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
        """ivector_estimator: an am.ivector.OnlineIvectorEstimator — when
        given, the current i-vector (re-estimated every ivector_period
        frames, from RAW pre-CMVN frames as the reference does) is
        appended to each output frame (the OnlineIvectorFeature input of
        online-nnet2-feature-pipeline.h)."""
        if deltas is not None and splice is not None:
            raise KaldiError("use deltas or splicing, not both")
        self.computer = computer
        self.cmvn = cmvn
        self.delta_opts = deltas
        self.splice_ctx = splice
        self.ivector_estimator = ivector_estimator
        self.ivector_period = ivector_period
        self._ivectors: List[torch.Tensor] = []   # per period-block
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
            if self.ivector_estimator is not None:
                self._update_ivectors()

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
        out = out[begin:end]
        if self.ivector_estimator is not None:
            out = torch.cat([out, self._ivector_rows(begin, end)], dim=1)
        return out

    # Port of kaldi_tpu/features/online.py OnlineFeaturePipeline
    # .set_frame_weights.
    def set_frame_weights(self, weights) -> None:
        """Silence-weighting hook: revise the i-vector estimator's
        per-frame weights (computed by OnlineSilenceWeighting from the
        decoder's partial traceback).  Affects FUTURE block estimates —
        the online protocol, matching the reference's greedy update."""
        if self.ivector_estimator is not None:
            self.ivector_estimator.update_frame_weights(weights)

    # Port of kaldi_tpu/features/online.py
    # OnlineFeaturePipeline._update_ivectors.
    def _update_ivectors(self) -> None:
        """Snapshot the i-vector at every period boundary as raw frames
        arrive (frame t reads the estimate from frames < its block's
        end — online causal re-estimation every ivector_period)."""
        est = self.ivector_estimator
        period = self.ivector_period
        n = self._frames.shape[0]
        while (len(self._ivectors) + 1) * period <= n:
            boundary = (len(self._ivectors) + 1) * period
            if boundary > est.num_frames:
                est.accept_frames(self._frames[est.num_frames:boundary])
            self._ivectors.append(est.ivector().to(torch.float32))

    # Port of kaldi_tpu/features/online.py
    # OnlineFeaturePipeline._ivector_rows.
    def _ivector_rows(self, begin: int, end: int) -> torch.Tensor:
        """(end − begin, K) float32: each frame's block estimate; frames
        past the last complete block read the current estimate (all
        frames so far go to the estimator first, as in the original)."""
        est = self.ivector_estimator
        n = self._frames.shape[0]
        if n > est.num_frames:
            est.accept_frames(self._frames[est.num_frames:])
        table = torch.stack(self._ivectors
                            + [est.ivector().to(torch.float32)])
        block = (torch.arange(begin, end, device=table.device)
                 // self.ivector_period).clamp_max(len(self._ivectors))
        return table[block]


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
