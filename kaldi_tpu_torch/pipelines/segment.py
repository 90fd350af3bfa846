# Copied from kaldi_tpu/pipelines/segment.py; imports rewritten to kaldi_tpu_torch, the VAD on ``device``.
"""Long-audio segmentation: VAD-driven splitting of long recordings
into decodable utterances, with optional decode-and-score refinement.

Parity targets: steps/cleanup/segment_long_utterances.sh and
utils/data/get_segments_for_data.sh (SURVEY.md §5 long-context row —
the reference's answer to long audio is pre-segmentation in data prep
plus streaming decode).  The reference segments by decoding against a
biased LM and splitting at silence; the equivalent here splits at
energy-VAD silence runs with the same segment-shaping contract: merge
close speech islands, drop too-short segments, split segments longer
than max-segment-length at their longest internal pause.

Output is a Kaldi `segments` table: (segment-id, reco-id, t-begin,
t-end) — what extract-segments consumes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

import torch

from kaldi_tpu_torch.am.ivector import VadEnergyOptions, compute_vad_energy
from kaldi_tpu_torch.core.logging import get_logger

log = get_logger(__name__)


@dataclasses.dataclass
class SegmentationOptions:
    frame_shift: float = 0.01          # seconds per VAD frame
    min_silence_length: float = 0.30   # gaps shorter than this merge
    min_segment_length: float = 0.30   # drop shorter segments
    max_segment_length: float = 10.0   # split longer segments
    segment_padding: float = 0.05      # context kept around speech
    # Raw frame log-energies (unlike MFCC C0) have no fixed scale, so
    # the segmentation default thresholds at the recording's mean
    # log-energy with light context smoothing rather than Kaldi's
    # absolute C0-scale default.
    vad: VadEnergyOptions = dataclasses.field(default_factory=lambda: (
        VadEnergyOptions(vad_energy_threshold=0.0,
                         vad_energy_mean_scale=1.0,
                         vad_frames_context=2,
                         vad_proportion_threshold=0.6)))


def _runs(mask: np.ndarray) -> List[Tuple[int, int]]:
    """[(start, end)) runs of True."""
    out: List[Tuple[int, int]] = []
    t = 0
    T = len(mask)
    while t < T:
        if mask[t]:
            s = t
            while t < T and mask[t]:
                t += 1
            out.append((s, t))
        else:
            t += 1
    return out


def segment_frames(vad: np.ndarray, opts: SegmentationOptions
                   ) -> List[Tuple[int, int]]:
    """VAD 0/1 per frame → [(begin_frame, end_frame)) segments after
    merge/drop/split shaping."""
    fs = opts.frame_shift
    min_sil = int(round(opts.min_silence_length / fs))
    min_seg = int(round(opts.min_segment_length / fs))
    max_seg = int(round(opts.max_segment_length / fs))
    pad = int(round(opts.segment_padding / fs))
    speech = _runs(np.asarray(vad) > 0.5)
    if not speech:
        return []
    # merge islands separated by short silence
    merged: List[Tuple[int, int]] = [speech[0]]
    for s, e in speech[1:]:
        if s - merged[-1][1] < min_sil:
            merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    # split over-long segments at their longest internal pause (or
    # evenly when no pause exists)
    shaped: List[Tuple[int, int]] = []
    vmask = np.asarray(vad) > 0.5

    def split(s: int, e: int) -> None:
        if e - s <= max_seg:
            shaped.append((s, e))
            return
        pauses = [(ps, pe) for ps, pe in _runs(~vmask[s:e])
                  if s + ps > s and s + pe < e]
        if pauses:
            ps, pe = max(pauses, key=lambda r: r[1] - r[0])
            mid = s + (ps + pe) // 2
        else:
            mid = s + (e - s) // 2
        split(s, mid)
        split(mid, e)

    for s, e in merged:
        split(s, e)
    # pad + drop short
    T = len(vad)
    out = []
    for s, e in shaped:
        if e - s < min_seg:
            continue
        out.append((max(0, s - pad), min(T, e + pad)))
    return out


def segment_long_audio(wave: np.ndarray, rate: float,
                       opts: Optional[SegmentationOptions] = None,
                       feats: Optional[np.ndarray] = None,
                       device: torch.device | str = "cuda"
                       ) -> List[Tuple[float, float]]:
    """Long waveform → [(t_begin, t_end)] utterance segments.  `feats`
    may supply precomputed features with C0/log-energy in column 0;
    otherwise frame log-energies are computed here.  The energy VAD
    runs on ``device``, the rest on the host."""
    opts = opts or SegmentationOptions()
    if feats is None:
        win = int(round(0.025 * rate))
        hop = int(round(opts.frame_shift * rate))
        T = max(0, (len(wave) - win) // hop + 1)
        if T == 0:
            return []
        idx = (np.arange(T)[:, None] * hop + np.arange(win)[None, :])
        frames = np.asarray(wave, np.float64)[idx]
        e = np.log(np.maximum((frames ** 2).sum(axis=1), 1e-10))
        feats = e[:, None]
    vad = compute_vad_energy(feats, opts.vad, device=device).cpu().numpy()
    fs = opts.frame_shift
    return [(s * fs, e * fs) for s, e in segment_frames(vad, opts)]


def write_segments(path: str, reco2segments: Dict[str, List[Tuple[float,
                                                                  float]]]
                   ) -> None:
    """Write the Kaldi `segments` file (what extract-segments reads)."""
    with open(path, "w") as f:
        for reco in sorted(reco2segments):
            for i, (tb, te) in enumerate(reco2segments[reco]):
                f.write(f"{reco}-{i:04d} {reco} {tb:.3f} {te:.3f}\n")
