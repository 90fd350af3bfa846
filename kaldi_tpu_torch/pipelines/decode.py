"""Decode pipelines: the TDNN-F serving path and the GMM decodes.

``decode_waveforms`` mirrors ``compute-fbank-feats`` followed by
``nnet3-latgen-faster-batch`` (kaldi_tpu/cli/tools_bank20.py): fbank
features, one TDNN forward per utterance, then length-padded batches
through ``BeamDecoder.decode_compact_batch``.

``decode_gmm`` and ``decode_gmm_lattice`` port
kaldi_tpu/pipelines/decode.py (parity target steps/decode.sh →
gmm-latgen-faster): GMM log-likelihoods on the model's device, then the
dense decoder, batched for one-best output or per utterance with
determinized lattices.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from kaldi_tpu_torch.am.transitions import TransitionModel
from kaldi_tpu_torch.core.logging import get_logger
from kaldi_tpu_torch.fst.fst import VectorFst
from kaldi_tpu_torch.fst.lang import Lang
from kaldi_tpu_torch.am.gmm import AmDiagGmm
from kaldi_tpu_torch.am.tdnn import TdnnChain
from kaldi_tpu_torch.decoder.beam import BeamDecoder, BeamDecoderConfig
from kaldi_tpu_torch.decoder.dense import DenseDecoder, DenseDecoderConfig
from kaldi_tpu_torch.features.compute import Fbank
from kaldi_tpu_torch.pipelines.score import WerStats, compute_wer

log = get_logger(__name__)


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


@dataclasses.dataclass
class DecodeResult:
    hyps: Dict[str, List[str]]
    alignments: Dict[str, List[int]]
    costs: Dict[str, float]
    wer: Optional[WerStats] = None
    lattices: Optional[Dict[str, object]] = None   # utt → CompactLattice


def decode_gmm_lattice(feats: Dict[str, np.ndarray], am: AmDiagGmm,
                       tm: TransitionModel, HCLG: VectorFst, lang: Lang,
                       beam: float = 16.0, lattice_beam: float = 8.0,
                       acoustic_scale: float = 0.1,
                       refs: Optional[Dict[str, List[str]]] = None,
                       device: torch.device | str = "cuda") -> DecodeResult:
    """gmm-latgen-faster equivalent on ``device``: decode with
    CompactLattice output.  ``am`` is moved to ``device``."""
    from kaldi_tpu_torch.lattice import determinize_lattice

    am.to(device)
    dec = DenseDecoder(HCLG, tm.tid_to_pdf_array,
                       DenseDecoderConfig(beam=beam,
                                          lattice_beam=lattice_beam,
                                          acoustic_scale=acoustic_scale),
                       device=device)
    hyps, alignments, costs, lats = {}, {}, {}, {}
    for u in sorted(feats):
        lat, _best = dec.decode_lattice(am.loglikes(feats[u]))
        clat = determinize_lattice(lat)
        words, tids, cost = clat.best_path()
        hyps[u] = [lang.words.find(w) for w in words]
        alignments[u] = tids
        costs[u] = cost
        lats[u] = clat
    result = DecodeResult(hyps, alignments, costs, lattices=lats)
    if refs is not None:
        result.wer = compute_wer(refs, hyps)
        log.info("decode(lattice): %s", result.wer)
    return result


def decode_gmm(feats: Dict[str, np.ndarray], am: AmDiagGmm,
               tm: TransitionModel, HCLG: VectorFst, lang: Lang,
               config: BeamDecoderConfig = None,
               refs: Optional[Dict[str, List[str]]] = None,
               batch_size: int = 8,
               device: torch.device | str = "cuda") -> DecodeResult:
    """One-best GMM decode on ``device``, ``batch_size`` utterances per
    dense-decoder batch.  ``am`` is moved to ``device``."""
    cfg = config or BeamDecoderConfig(beam=16.0, max_active=2000,
                                      acoustic_scale=0.1)
    am.to(device)
    dec = DenseDecoder(HCLG, tm.tid_to_pdf_array,
                       DenseDecoderConfig(beam=cfg.beam,
                                          acoustic_scale=cfg.acoustic_scale),
                       device=device)
    utts = sorted(feats)
    hyps: Dict[str, List[str]] = {}
    alignments: Dict[str, List[int]] = {}
    costs: Dict[str, float] = {}
    for i in range(0, len(utts), batch_size):
        chunk = utts[i:i + batch_size]
        lls = [am.loglikes(feats[u]) for u in chunk]
        lens = np.array([len(ll) for ll in lls], np.int64)
        batch = torch.zeros((len(chunk), int(lens.max()), am.num_pdfs),
                            dtype=torch.float32, device=am.device)
        for b, ll in enumerate(lls):
            batch[b, :len(ll)] = ll
        for u, (tids, ols, cost) in zip(chunk,
                                        dec.decode_batch(batch, lens)):
            hyps[u] = [lang.words.find(o) for o in ols]
            alignments[u] = tids
            costs[u] = cost
    result = DecodeResult(hyps, alignments, costs)
    if refs is not None:
        result.wer = compute_wer(refs, hyps)
        log.info("decode: %s", result.wer)
    return result
