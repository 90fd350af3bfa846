# Copied from kaldi_tpu/lattice/word_align.py; imports rewritten to kaldi_tpu_torch.
"""Word alignment of full lattices.

Parity target: src/lat/word-align-lattice.h WordAlignLattice — rewrite
a CompactLattice so every arc carries exactly one word (or one silence
run) with its tid string cut at true word boundaries.  Determinization
splits tid strings at path-DIVERGENCE points, not word boundaries; MBR
sausage times, per-word confidences, and full-lattice CTMs all need
the realigned form.

Algorithm (the reference's chunk-consuming traversal, re-expressed):
output states are (input state, pending tids, pending words); each
input arc appends its tids/olabel to the pending buffers, then
complete units are emitted greedily from the front:

  * a maximal run of silence phones (no word label consumed)
  * a word whose pronunciation matches the leading phone runs

A unit is only emitted once its last phone run is provably complete —
i.e. a following phone has started in the pending buffer, or the
input state is final.  Arc weights ride on the first arc emitted for
the chunk (weight placement within a path does not change path
weights in the tropical semiring).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.am.transitions import TransitionModel
from kaldi_tpu_torch.lattice.lattice import CompactArc, CompactLattice

log = get_logger(__name__)


def _runs(tm: TransitionModel, tids: Sequence[int]
          ) -> List[Tuple[int, List[int]]]:
    """[(phone, [tids])] runs; a run starts at an initial non-self-loop
    tid of hmm-state 0 (reorder=true convention)."""
    out: List[Tuple[int, List[int]]] = []
    for tid in tids:
        phone = tm.transition_id_to_phone(tid)
        is_initial = (tm.transition_id_to_hmm_state(tid) == 0
                      and not tm.is_self_loop(tid))
        if is_initial or not out or out[-1][0] != phone:
            out.append((phone, [tid]))
        else:
            out[-1][1].append(tid)
    return out


class _Aligner:
    def __init__(self, tm: TransitionModel,
                 prons: Dict[int, List[List[int]]],
                 silence_phones: Set[int]):
        self.tm = tm
        self.prons = prons
        self.sil = silence_phones
        self.ok = True

    def emit_units(self, tids: Tuple[int, ...], words: Tuple[int, ...],
                   at_final: bool):
        """Split the pending buffer's FRONT into complete units.
        Returns (units, rest_tids, rest_words) where each unit is
        (word, unit_tids)."""
        units: List[Tuple[int, Tuple[int, ...]]] = []
        runs = _runs(self.tm, tids)
        words = list(words)
        ri = 0
        while ri < len(runs):
            last_complete = (ri < len(runs) - 1) or at_final
            phone = runs[ri][0]
            if phone in self.sil:
                # maximal silence run (usually length 1)
                rj = ri
                while rj < len(runs) and runs[rj][0] in self.sil:
                    rj += 1
                if rj == len(runs) and not at_final:
                    break                      # run may continue
                unit = [t for _, ts in runs[ri:rj] for t in ts]
                units.append((0, tuple(unit)))
                ri = rj
                continue
            if not words:
                break
            matched = False
            for pron in self.prons.get(words[0], []):
                n = len(pron)
                if ri + n > len(runs):
                    continue
                if [p for p, _ in runs[ri:ri + n]] != list(pron):
                    continue
                if ri + n == len(runs) and not at_final:
                    continue                   # last run maybe incomplete
                unit = [t for _, ts in runs[ri:ri + n] for t in ts]
                units.append((words.pop(0), tuple(unit)))
                ri += n
                matched = True
                break
            if not matched:
                if at_final and self.prons.get(words[0]):
                    # salvage: assign one run to the word (mismatch)
                    self.ok = False
                    unit = runs[ri][1]
                    units.append((words.pop(0), tuple(unit)))
                    ri += 1
                    continue
                break
        rest = [t for _, ts in runs[ri:] for t in ts]
        return units, tuple(rest), tuple(words)


def word_align_lattice(clat: CompactLattice, tm: TransitionModel,
                       prons: Dict[int, List[List[int]]],
                       silence_phones: Optional[Set[int]] = None,
                       max_states: int = 200000
                       ) -> Tuple[CompactLattice, bool]:
    """→ (word-aligned CompactLattice, success flag).  Path word
    sequences and total weights are preserved exactly; every output
    arc carries one word (olabel > 0) or one silence run (olabel 0);
    the flag is False if any pronunciation failed to match (the arcs
    are still emitted, with best-effort splits)."""
    silence_phones = silence_phones or set()
    al = _Aligner(tm, prons, silence_phones)
    out = CompactLattice()
    state_map: Dict[Tuple[int, Tuple[int, ...], Tuple[int, ...]], int] = {}
    finals_of = dict(clat.finals)

    def get_state(key):
        if key not in state_map:
            if len(state_map) >= max_states:
                raise KaldiError("word_align_lattice: state blowup")
            state_map[key] = out.add_state()
        return state_map[key]

    start_key = (clat.start, (), ())
    out.start = get_state(start_key)
    queue = [start_key]
    seen = {start_key}
    while queue:
        key = queue.pop()
        in_state, pend_tids, pend_words = key
        src = state_map[key]

        if in_state in finals_of:
            gc, ac, ftids = finals_of[in_state]
            tids = pend_tids + tuple(ftids)
            units, rest, words_left = al.emit_units(tids, pend_words, True)
            if words_left or rest:
                al.ok = False
                if rest:
                    units = units + [(words_left[0] if words_left else 0,
                                      rest)]
                    words_left = words_left[1:]
                for w in words_left:
                    units = units + [(w, ())]
            if not units:
                prev = out.finals.get(src)
                if prev is None or gc + ac < prev[0] + prev[1]:
                    out.finals[src] = (gc, ac, ())
            else:
                cur = src
                first = True
                for i, (word, unit) in enumerate(units):
                    dst = out.add_state()
                    out.arcs[cur].append(CompactArc(
                        word, gc if first else 0.0, ac if first else 0.0,
                        unit, dst))
                    first = False
                    cur = dst
                out.finals[cur] = (0.0, 0.0, ())

        for a in clat.arcs[in_state]:
            tids = pend_tids + tuple(a.tids)
            words = pend_words + ((a.word,) if a.word else ())
            units, rest_tids, rest_words = al.emit_units(tids, words, False)
            rest_key = (a.nextstate, rest_tids, rest_words)
            if not units:
                dst = get_state(rest_key)
                if rest_key not in seen:
                    seen.add(rest_key)
                    queue.append(rest_key)
                # ε-like connector arc carrying the weight
                out.arcs[src].append(CompactArc(
                    0, a.graph_cost, a.acoustic_cost, (), dst))
                continue
            cur = src
            first = True
            for i, (word, unit) in enumerate(units):
                if i == len(units) - 1:
                    dst = get_state(rest_key)
                    if rest_key not in seen:
                        seen.add(rest_key)
                        queue.append(rest_key)
                else:
                    dst = out.add_state()
                out.arcs[cur].append(CompactArc(
                    word, a.graph_cost if first else 0.0,
                    a.acoustic_cost if first else 0.0, unit, dst))
                first = False
                cur = dst
    return out, al.ok


def lattice_word_times(clat: CompactLattice
                       ) -> List[List[Tuple[int, int, int]]]:
    """Per-arc (word, begin_frame, num_frames) along each state's
    arcs of a word-ALIGNED lattice, using state times (the
    CompactLatticeStateTimes role)."""
    order = clat.top_order()
    times = [0] * clat.num_states
    for s in order:
        for a in clat.arcs[s]:
            t = times[s] + len(a.tids)
            times[a.nextstate] = max(times[a.nextstate], t)
    out: List[List[Tuple[int, int, int]]] = []
    for s in range(clat.num_states):
        row = []
        for a in clat.arcs[s]:
            row.append((a.word, times[s], len(a.tids)))
        out.append(row)
    return out
