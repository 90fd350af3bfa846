# Copied from kaldi_tpu/fst/context.py; imports rewritten to kaldi_tpu_torch.
"""Context-dependency composition: LG → CLG.

Parity target: src/fstext/context-fst.h (InverseContextFst) and
src/fstbin/fstcomposecontext.cc — build C on demand while composing, so
the full C transducer is never materialized.

For context width N and central position P, phones are emitted with a
delay of (N−1−P) arcs: consuming phone c completes the window of the
phone seen (N−1−P) arcs earlier.  State = (LG state, history of the
last N−1 phones); at final states the pending phones flush with empty
right context.  Disambiguation symbols pass through with fresh CLG ids.

Returns (CLG, ilabel_info, disambig_start): ilabel_info[i] is the phone
window tuple for CLG ilabel i (or the passthrough disambig), exactly
what make_h_transducer consumes.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Tuple

from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.fst.fst import EPS, Arc, VectorFst

log = get_logger(__name__)


def compose_context(LG: VectorFst, lang, N: int, P: int
                    ) -> Tuple[VectorFst, List[Tuple[int, ...]], int]:
    if LG.start < 0:
        raise KaldiError("compose_context: empty LG")
    delay = N - 1 - P
    phone_ids = set(lang.phone_list())
    disambig_ids = set(lang.disambig_ids)

    # window → CLG ilabel; built on demand. id 0 stays ε.
    window_ids: Dict[Tuple[int, ...], int] = {}
    ilabel_info: List[Tuple[int, ...]] = [(0,)]     # slot 0 = ε

    def window_id(win: Tuple[int, ...]) -> int:
        if win not in window_ids:
            window_ids[win] = len(ilabel_info)
            ilabel_info.append(win)
        return window_ids[win]

    out = VectorFst()
    state_map: Dict[Tuple[int, Tuple[int, ...]], int] = {}

    def get_state(lg_s: int, hist: Tuple[int, ...]) -> int:
        key = (lg_s, hist)
        if key not in state_map:
            state_map[key] = out.add_state()
        return state_map[key]

    init_hist = (0,) * (N - 1)
    start_key = (LG.start, init_hist)
    out.set_start(get_state(*start_key))
    queue = deque([start_key])
    seen = {start_key}

    def emit_window(hist: Tuple[int, ...], new_phone: int
                    ) -> Tuple[int, Tuple[int, ...]]:
        """Push new_phone into history; the completed window is centered
        on hist[P] (with new_phone as its rightmost context)."""
        full = hist + (new_phone,)               # length N
        center = full[P]
        if center == 0:
            # not enough phones seen yet — no emission (delay phase)
            return EPS, full[1:]
        return window_id(full), full[1:]

    while queue:
        lg_s, hist = queue.popleft()
        src = state_map[(lg_s, hist)]

        for a in LG.arcs[lg_s]:
            if a.ilabel in disambig_ids:
                # passthrough; resolved to CLG disambig ids below
                nk = (a.nextstate, hist)
                dst = get_state(*nk)
                out.add_arc(src, Arc(-a.ilabel, a.olabel, a.weight, dst))
            elif a.ilabel == EPS:
                nk = (a.nextstate, hist)
                dst = get_state(*nk)
                out.add_arc(src, Arc(EPS, a.olabel, a.weight, dst))
            elif a.ilabel in phone_ids:
                il, nhist = emit_window(hist, a.ilabel)
                nk = (a.nextstate, nhist)
                dst = get_state(*nk)
                out.add_arc(src, Arc(il, a.olabel, a.weight, dst))
            else:
                raise KaldiError(f"compose_context: unknown ilabel {a.ilabel}")
            if nk not in seen:
                seen.add(nk)
                queue.append(nk)

        if LG.is_final(lg_s):
            # flush pending phones with empty right context
            cur = src
            h = hist
            pending = sum(1 for i in range(P, N - 1) if h[i] != 0)
            for _ in range(pending):
                il, h = emit_window(h, 0)
                nxt = out.add_state()
                out.add_arc(cur, Arc(il, EPS, 0.0, nxt))
                cur = nxt
            out.set_final(cur, LG.final(lg_s))

    # assign CLG ids to disambig symbols (after all windows are known)
    disambig_start = len(ilabel_info)
    disambig_map: Dict[int, int] = {}
    for d in sorted(disambig_ids):
        disambig_map[d] = len(ilabel_info)
        ilabel_info.append((d,))
    for arcs in out.arcs:
        for a in arcs:
            if a.ilabel < 0:
                a.ilabel = disambig_map[-a.ilabel]

    from kaldi_tpu_torch.fst.ops import connect
    clg = connect(out)
    log.info("compose_context: N=%d P=%d → %d windows, CLG %s",
             N, P, len(window_ids), clg)
    return clg.arcsort("ilabel"), ilabel_info, disambig_start
