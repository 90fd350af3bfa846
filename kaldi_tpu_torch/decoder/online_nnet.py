"""Streaming neural acoustic scoring.

Port of kaldi_tpu/decoder/online_nnet.py (parity target
src/nnet3/decodable-online-looped.h DecodableAmNnetLoopedOnline):
context-buffered chunk scoring.  A TDNN's state is its finite receptive
field, so the scorer keeps the feature frames on the device, delays
emission by ``right_context`` frames and scores each chunk with
``left_context`` past and ``right_context`` future frames attached.
Emitted scores equal the offline forward's when both contexts cover the
model's receptive field: ±1 for the input splice plus ±s for each TDNN-F
layer of time stride s, ±34 at the 13-layer bench width (strides
[1, 1, 1] + [3] * 10), where the default 24 falls short.  A fault of the
original is repaired to its intent: at the end of input it emits all
⌈T / subsample⌉ frames the offline forward gives (as Kaldi's
DecodableNnetLoopedOnline::NumFramesReady does), not ⌊T / subsample⌋.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.device import resolve_device

log = get_logger(__name__)


class OnlineNnetScorer:
    """Feed feature chunks, read subsampled score frames (tensors on
    ``device``)."""

    def __init__(self, model: Callable[[torch.Tensor], torch.Tensor],
                 left_context: int = 24, right_context: int = 24,
                 subsample: int = 3, device: torch.device | str = "cuda"):
        """model: (1, T, D) → (1, ⌈T / subsample⌉, P) on ``device``, e.g.
        a ``TdnnChain`` there."""
        self.model = model
        self.device = resolve_device(device)
        self.left = left_context
        self.right = right_context
        self.sub = subsample
        self._feats: Optional[torch.Tensor] = None
        self._emitted_sub = 0          # subsampled frames already emitted
        self._finished = False

    def accept_features(self, feats) -> None:
        if self._finished:
            raise KaldiError("accept_features after input_finished")
        feats = torch.as_tensor(feats, dtype=torch.float32,
                                device=self.device)
        self._feats = (feats if self._feats is None
                       else torch.cat([self._feats, feats]))

    def input_finished(self) -> None:
        self._finished = True

    def num_frames_ready(self) -> int:
        """Subsampled score frames currently computable: once the input
        has finished, all ⌈T / subsample⌉ of the offline forward (the
        original stops at ⌊T / subsample⌋ and drops the last one)."""
        if self._feats is None:
            return 0
        T = self._feats.shape[0]
        if self._finished:
            return -(-T // self.sub)
        return max(0, T - self.right) // self.sub

    def get_scores(self, begin_sub: int, end_sub: int) -> torch.Tensor:
        """Scores for subsampled frames [begin_sub, end_sub)."""
        if end_sub > self.num_frames_ready():
            raise KaldiError("scores not ready")
        # score the window [begin_full - left, end_full + right] and cut
        begin_full = begin_sub * self.sub
        end_full = end_sub * self.sub
        lo = max(0, begin_full - self.left)
        # keep lo aligned to the subsampling grid so frame phases match
        lo -= lo % self.sub
        hi = min(self._feats.shape[0], end_full + self.right)
        with torch.no_grad():
            scores = self.model(self._feats[lo:hi][None])[0]
        off = (begin_full - lo) // self.sub
        return scores[off:off + (end_sub - begin_sub)]

    def read_new(self) -> torch.Tensor:
        """All not-yet-emitted ready frames (streaming pull); (0, 0) when
        there are none."""
        ready = self.num_frames_ready()
        if ready <= self._emitted_sub:
            return torch.zeros((0, 0), device=self.device)
        out = self.get_scores(self._emitted_sub, ready)
        self._emitted_sub = ready
        return out
