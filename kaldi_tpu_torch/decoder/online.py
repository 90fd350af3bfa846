"""Streaming (online) decoding on the dense decoder, and endpointing.

Port of kaldi_tpu/decoder/online.py (parity targets
src/online2/online-nnet3-decoding.h SingleUtteranceNnet3Decoder,
src/decoder/lattice-faster-online-decoder.h BestPathEnd /
TraceBackBestPath, src/online2/online-endpoint.h).  The decoder carries
the dense α vector across chunks on the DenseDecoder's device; each
chunk runs ``DenseDecoder._frame_step`` once per frame it has (the
original's padded fixed-size chunk served XLA's compile cache) and
appends the chunk's backpointers to a host-side list, which the partial
and final tracebacks walk.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.decoder.dense import BIG, DenseDecoder

log = get_logger(__name__)


# Copied from kaldi_tpu/decoder/online.py OnlineEndpointRule.
@dataclasses.dataclass
class OnlineEndpointRule:
    """One endpointing rule (online-endpoint.h OnlineEndpointRule)."""
    must_contain_nonsilence: bool
    min_trailing_silence: float      # seconds
    max_relative_cost: float = 1e10
    min_utterance_length: float = 0.0


# Copied from kaldi_tpu/decoder/online.py default_endpoint_rules.
def default_endpoint_rules() -> List[OnlineEndpointRule]:
    """The reference's 5 default rules."""
    return [
        OnlineEndpointRule(False, 5.0, 1e10, 0.0),    # rule1
        OnlineEndpointRule(True, 0.5, 2.0, 0.0),      # rule2
        OnlineEndpointRule(True, 1.0, 8.0, 0.0),      # rule3
        OnlineEndpointRule(True, 2.0, 1e10, 0.0),     # rule4
        OnlineEndpointRule(False, 0.0, 1e10, 20.0),   # rule5
    ]


class SingleUtteranceDecoder:
    """Streaming wrapper over DenseDecoder for one utterance, on the
    decoder's device."""

    def __init__(self, decoder: DenseDecoder, chunk_frames: int = 32,
                 frame_shift: float = 0.01, silence_phones=(),
                 trans_model=None):
        self.dec = decoder
        self.chunk = chunk_frames
        self.frame_shift = frame_shift
        self.silence_phones = set(silence_phones)
        self.tm = trans_model
        g = decoder.graph
        dev = decoder.device
        alpha = torch.full((1, g.num_states), BIG, dtype=torch.float32,
                           device=dev)
        alpha[0, g.start] = 0.0
        # the initial ε-closure
        self._alpha = decoder._alpha_eps(alpha[0])[None]
        self._active = torch.ones((1, 1), dtype=torch.bool, device=dev)
        self._bps: List[np.ndarray] = []       # per frame (E+1, S)
        self._T = 0

    # -- streaming API ------------------------------------------------------
    def advance_decoding(self, loglikes) -> None:
        """Consume (n, P) new frames of acoustic scores (numpy or a
        tensor), in chunks of ``chunk_frames``; each chunk's backpointers
        come to the host once."""
        dec = self.dec
        ll = torch.as_tensor(loglikes, dtype=torch.float32,
                             device=dec.device)
        n = ll.shape[0]
        E1 = dec.graph.eps_depth + 1
        S = dec.graph.num_states
        for i in range(0, n, self.chunk):
            take = min(self.chunk, n - i)
            bps = torch.empty((take, E1, 1, S), dtype=torch.int32,
                              device=dec.device)
            for t in range(take):
                self._alpha = dec._frame_step(self._alpha, ll[i + t][None],
                                              self._active, bps[t])
            self._bps.extend(bps[:, :, 0].cpu().numpy())
            self._T += take

    @property
    def num_frames_decoded(self) -> int:
        return self._T

    # Port of kaldi_tpu/decoder/online.py SingleUtteranceDecoder._best_state.
    def _best_state(self, use_final: bool) -> Tuple[int, float, float]:
        alpha = self._alpha[0].cpu().numpy()
        final = np.asarray(self.dec.graph.final)
        if use_final:
            total = alpha + final
            if total.min() < 1e29:
                s = int(np.argmin(total))
                return s, float(total[s]), float(alpha.min())
        s = int(np.argmin(alpha))
        return s, float(alpha[s]), float(alpha.min())

    # Copied from kaldi_tpu/decoder/online.py SingleUtteranceDecoder._traceback.
    def _traceback(self, state: int) -> Tuple[List[int], List[int]]:
        g = self.dec.graph
        s = state
        rev_tids: List[int] = []
        rev_ols: List[int] = []
        for t in range(self._T - 1, -1, -1):
            bp_t = self._bps[t]
            E1 = bp_t.shape[0]
            for e in range(E1 - 1, 0, -1):
                slot = int(bp_t[e, s])
                if slot >= 0:
                    ol = int(g.n_ol[s, slot])
                    if ol:
                        rev_ols.append(ol)
                    s = int(g.n_src[s, slot])
            slot = int(bp_t[0, s])
            if slot < 0:
                raise KaldiError("online traceback: broken chain")
            tid = int(g.e_il[s, slot])
            ol = int(g.e_ol[s, slot])
            if ol:
                rev_ols.append(ol)
            rev_tids.append(tid)
            s = int(g.e_src[s, slot])
        rev_tids.reverse()
        rev_ols.reverse()
        return rev_tids, rev_ols

    # Copied from kaldi_tpu/decoder/online.py SingleUtteranceDecoder.get_best_path.
    def get_best_path(self, use_final_probs: bool = False
                      ) -> Tuple[List[int], List[int], float]:
        """Partial (or final) result at any time
        (LatticeFasterOnlineDecoder::BestPathEnd + TraceBackBestPath)."""
        if self._T == 0:
            return [], [], 0.0
        s, cost, _ = self._best_state(use_final_probs)
        tids, ols = self._traceback(s)
        return tids, ols, cost

    # -- endpointing --------------------------------------------------------
    # Copied from kaldi_tpu/decoder/online.py
    # SingleUtteranceDecoder.trailing_silence_frames.
    def trailing_silence_frames(self) -> int:
        if self.tm is None or not self.silence_phones:
            return 0
        tids, _ = self._traceback(self._best_state(False)[0])
        n = 0
        for tid in reversed(tids):
            if self.tm.transition_id_to_phone(tid) in self.silence_phones:
                n += 1
            else:
                break
        return n

    # Copied from kaldi_tpu/decoder/online.py
    # SingleUtteranceDecoder.endpoint_detected.
    def endpoint_detected(self,
                          rules: Optional[List[OnlineEndpointRule]] = None
                          ) -> bool:
        """online-endpoint.h EndpointDetected."""
        if self._T == 0:
            return False
        rules = rules or default_endpoint_rules()
        utt_len = self._T * self.frame_shift
        trailing = self.trailing_silence_frames() * self.frame_shift
        contains_nonsil = trailing < utt_len
        _, best_cost, best_any = self._best_state(True)
        relative_cost = best_cost - best_any
        for r in rules:
            if r.must_contain_nonsilence and not contains_nonsil:
                continue
            if trailing < r.min_trailing_silence:
                continue
            if relative_cost > r.max_relative_cost:
                continue
            if utt_len < r.min_utterance_length:
                continue
            return True
        return False
