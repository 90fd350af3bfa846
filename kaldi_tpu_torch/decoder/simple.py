# Copied from kaldi_tpu/decoder/simple.py; imports rewritten to kaldi_tpu_torch.
"""Reference NumPy Viterbi decoder (unpruned) — the correctness oracle.

Parity target: src/decoder/simple-decoder.h (SimpleDecoder).  Exact
Viterbi over the full state space with per-frame ε-closure; used by
tests as the oracle for the vectorized TPU beam decoder, exactly as the
reference validates FasterDecoder/LatticeFasterDecoder against
SimpleDecoder on small graphs (SURVEY.md §4).
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np

from kaldi_tpu_torch.core.logging import KaldiError
from kaldi_tpu_torch.fst.fst import EPS, INF, VectorFst


class SimpleDecoder:
    def __init__(self, fst: VectorFst, acoustic_scale: float = 1.0):
        self.fst = fst
        self.acoustic_scale = acoustic_scale

    def decode(self, loglikes: np.ndarray, tid_to_pdf: np.ndarray
               ) -> Tuple[List[int], List[int], float]:
        """loglikes: (T, num_pdfs).  Returns (tid alignment, olabel
        sequence, total cost) of the best path; raises if no path."""
        fst = self.fst
        T = loglikes.shape[0]
        # token: state → (cost, backpointer)
        # backpointer: (frame, prev_state, ilabel, olabel) chain stored per
        # (frame, state) in bp[(t, s)] = (prev_t, prev_s, tid, olabel)
        cur: Dict[int, float] = {fst.start: 0.0}
        bp: Dict[Tuple[int, int], Tuple[int, int, int, int]] = {}
        cur = self._eps_closure(cur, bp, 0)
        for t in range(T):
            nxt: Dict[int, float] = {}
            for s, cost in cur.items():
                for a in fst.arcs[s]:
                    if a.ilabel == EPS:
                        continue
                    pdf = tid_to_pdf[a.ilabel]
                    ac = -self.acoustic_scale * loglikes[t, pdf]
                    nc = cost + a.weight + ac
                    if nc < nxt.get(a.nextstate, INF):
                        nxt[a.nextstate] = nc
                        bp[(t + 1, a.nextstate)] = (t, s, a.ilabel, a.olabel)
            if not nxt:
                raise KaldiError(f"SimpleDecoder: no tokens at frame {t}")
            cur = self._eps_closure(nxt, bp, t + 1)

        best_s, best_cost = -1, INF
        for s, cost in cur.items():
            fw = fst.final(s)
            if fw != INF and cost + fw < best_cost:
                best_cost = cost + fw
                best_s = s
        if best_s < 0:
            raise KaldiError("SimpleDecoder: no final state reached")

        # backtrace
        tids: List[int] = []
        olabels: List[int] = []
        t, s = T, best_s
        while (t, s) in bp:
            pt, ps, tid, ol = bp[(t, s)]
            if tid != EPS:
                tids.append(tid)
            if ol != EPS:
                olabels.append(ol)
            t, s = pt, ps
        tids.reverse()
        olabels.reverse()
        return tids, olabels, best_cost

    def _eps_closure(self, toks: Dict[int, float],
                     bp: Dict, frame: int) -> Dict[int, float]:
        heap = [(c, s) for s, c in toks.items()]
        heapq.heapify(heap)
        best = dict(toks)
        while heap:
            c, s = heapq.heappop(heap)
            if c > best.get(s, INF):
                continue
            for a in self.fst.arcs[s]:
                if a.ilabel != EPS:
                    continue
                nc = c + a.weight
                if nc < best.get(a.nextstate, INF) - 1e-12:
                    best[a.nextstate] = nc
                    bp[(frame, a.nextstate)] = (frame, s, EPS, a.olabel)
                    heapq.heappush(heap, (nc, a.nextstate))
        return best
