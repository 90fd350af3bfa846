# Copied from kaldi_tpu/lattice/ctm.py; imports rewritten to kaldi_tpu_torch.
"""Word-aligned output: CTM (time-marked conversation) generation.

Parity targets: src/lat/word-align-lattice.h + nbest-to-ctm /
steps/get_train_ctm.sh — per-word begin/duration times.

CompactLattice arcs carry transition-id strings, but determinization
splits them at path-divergence points, NOT at word boundaries (the
exact problem word-align-lattice solves in the reference).  So the
best-path CTM is produced by re-aligning the full path's tid string:
phones are recovered with the TransitionModel, then matched against
each word's lexicon pronunciation in order, with silence runs between
words unassigned — the 1-best equivalent of WordAlignLattice with the
standard word-boundary conventions.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.am.transitions import TransitionModel
from kaldi_tpu_torch.lattice.lattice import CompactLattice

log = get_logger(__name__)


@dataclasses.dataclass
class CtmEntry:
    utt: str
    channel: int
    begin: float
    duration: float
    word: str
    confidence: float = 1.0

    def __str__(self) -> str:
        return (f"{self.utt} {self.channel} {self.begin:.2f} "
                f"{self.duration:.2f} {self.word} {self.confidence:.2f}")


def phone_runs(tm: TransitionModel, tids: Sequence[int]
               ) -> List[Tuple[int, int]]:
    """[(phone, num_frames)] runs of a tid alignment."""
    runs: List[Tuple[int, int]] = []
    for tid in tids:
        phone = tm.transition_id_to_phone(tid)
        is_initial = (tm.transition_id_to_hmm_state(tid) == 0
                      and not tm.is_self_loop(tid))
        if is_initial or not runs:
            runs.append((phone, 1))
        else:
            runs[-1] = (runs[-1][0], runs[-1][1] + 1)
    return runs


def align_words_to_phones(words: Sequence[int], tids: Sequence[int],
                          tm: TransitionModel,
                          prons: Dict[int, List[List[int]]],
                          silence_phones: Set[int]
                          ) -> List[Tuple[int, int, int]]:
    """→ [(word, begin_frame, num_frames)] by consuming each word's
    pronunciation phones from the path's phone runs."""
    runs = phone_runs(tm, tids)
    out: List[Tuple[int, int, int]] = []
    t = 0
    ri = 0
    for word in words:
        # skip silence runs between words
        while ri < len(runs) and runs[ri][0] in silence_phones:
            t += runs[ri][1]
            ri += 1
        matched = False
        for pron in prons.get(word, []):
            if [p for p, _ in runs[ri:ri + len(pron)]] == list(pron):
                dur = sum(d for _, d in runs[ri:ri + len(pron)])
                out.append((word, t, dur))
                t += dur
                ri += len(pron)
                matched = True
                break
        if not matched:
            # fall back: assign the next non-silence run to the word
            if ri < len(runs):
                out.append((word, t, runs[ri][1]))
                t += runs[ri][1]
                ri += 1
            else:
                out.append((word, t, 1))
            log.warning("ctm: pronunciation mismatch for word %d", word)
    return out


def best_path_ctm(clat: CompactLattice, tm: TransitionModel, words_table,
                  utt: str, silence_phones: Optional[Set[int]] = None,
                  frame_shift: float = 0.01,
                  prons: Optional[Dict[int, List[List[int]]]] = None,
                  confidences: Optional[List[float]] = None
                  ) -> List[CtmEntry]:
    """CTM entries for the lattice best path.

    ``prons``: word-id → list of phone-id pronunciations (from
    fst.lang.Lang; see lang_prons()).  Without it, falls back to the
    per-arc tid-string segmentation (inexact at divergence points).
    """
    silence_phones = silence_phones or set()
    words, tids, _cost = clat.best_path()
    if not words:
        return []
    if prons:
        aligned = align_words_to_phones(words, tids, tm, prons,
                                        silence_phones)
    else:
        aligned = _arc_segmentation(clat, tm, silence_phones)
    out = []
    for i, (word, begin, dur) in enumerate(aligned):
        conf = confidences[i] if confidences and i < len(confidences) else 1.0
        out.append(CtmEntry(utt, 1, begin * frame_shift, dur * frame_shift,
                            words_table.find(word), conf))
    return out


def lang_prons(lang) -> Dict[int, List[List[int]]]:
    """word-id → phone-id pronunciation lists from a fst.lang.Lang."""
    out: Dict[int, List[List[int]]] = {}
    for word, pron, _prob in lang.lexicon.normalized():
        wid = lang.words[word]
        out.setdefault(wid, []).append([lang.phones[p] for p in pron])
    return out


def _arc_segmentation(clat: CompactLattice, tm: TransitionModel,
                      silence_phones: Set[int]
                      ) -> List[Tuple[int, int, int]]:
    """Per-arc fallback (tid strings as-is, silence edges trimmed)."""
    INF = float("inf")
    order = clat.top_order()
    dist = [INF] * clat.num_states
    back = [None] * clat.num_states
    dist[clat.start] = 0.0
    for s in order:
        if dist[s] == INF:
            continue
        for a in clat.arcs[s]:
            nd = dist[s] + a.total
            if nd < dist[a.nextstate]:
                dist[a.nextstate] = nd
                back[a.nextstate] = (s, a)
    best_s, best = -1, INF
    for s, (gc, ac, _) in clat.finals.items():
        if dist[s] + gc + ac < best:
            best = dist[s] + gc + ac
            best_s = s
    if best_s < 0:
        return []
    arcs = []
    s = best_s
    while s != clat.start:
        ps, a = back[s]
        arcs.append(a)
        s = ps
    arcs.reverse()
    out = []
    t = 0
    for a in arcs:
        n = len(a.tids)
        if a.word:
            lead = 0
            for tid in a.tids:
                if tm.transition_id_to_phone(tid) in silence_phones:
                    lead += 1
                else:
                    break
            trail = 0
            for tid in reversed(a.tids):
                if tm.transition_id_to_phone(tid) in silence_phones:
                    trail += 1
                else:
                    break
            if lead + trail >= n:
                lead = trail = 0
            out.append((a.word, t + lead, max(n - lead - trail, 1)))
        t += n
    return out
