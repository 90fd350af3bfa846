"""Waveforms → determinized lattices: the serving path.

Mirrors ``compute-fbank-feats`` followed by
``nnet3-latgen-faster-batch`` (kaldi_tpu/cli/tools_bank20.py): fbank
features, one TDNN forward per utterance, then length-padded batches
through ``BeamDecoder.decode_compact_batch``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from kaldi_tpu_torch.am.tdnn import TdnnChain
from kaldi_tpu_torch.decoder.beam import BeamDecoder
from kaldi_tpu_torch.features.compute import Fbank


def acoustic_scores(waves: Sequence[np.ndarray], fbank: Fbank,
                    model: TdnnChain) -> List[torch.Tensor]:
    """Per utterance (T_sub, num_pdfs) chain outputs on the model's
    device."""
    with torch.no_grad():
        return [model(fbank.compute(w)[None])[0] for w in waves]


def decode_scores(scores: Sequence[torch.Tensor], decoder: BeamDecoder,
                  batch_size: int, stats: Optional[Dict] = None):
    """Batches of ``batch_size`` utterances, each padded to a multiple
    of 64 frames, through ``decode_compact_batch``."""
    lats = []
    for i in range(0, len(scores), batch_size):
        chunk = scores[i:i + batch_size]
        T_pad = int(np.ceil(max(len(x) for x in chunk) / 64) * 64)
        P = chunk[0].shape[1]
        X = torch.zeros((len(chunk), T_pad, P), dtype=torch.float32,
                        device=chunk[0].device)
        lens = np.zeros(len(chunk), np.int64)
        for b, ll in enumerate(chunk):
            X[b, :len(ll)] = ll
            lens[b] = len(ll)
        lats.extend(decoder.decode_compact_batch(X, lens, stats=stats))
    return lats


def decode_waveforms(waves: Sequence[np.ndarray], fbank: Fbank,
                     model: TdnnChain, decoder: BeamDecoder,
                     batch_size: int, stats: Optional[Dict] = None):
    """16 kHz waveforms → one determinized CompactLattice each."""
    return decode_scores(acoustic_scores(waves, fbank, model), decoder,
                         batch_size, stats=stats)
