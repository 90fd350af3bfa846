# Copied from kaldi_tpu/decoder/biglm.py; imports rewritten to kaldi_tpu_torch.
"""Big-LM decoding: on-the-fly composition with a difference LM.

Parity target: src/decoder/lattice-biglm-faster-decoder.h and
gmmbin/gmm-latgen-biglm-faster.cc — decode over an HCLG compiled with
a SMALL LM while composing, token by token, with the "difference"
G_small⁻¹∘G_big (a deterministic-on-demand FST over big-LM histories),
so the search effectively runs under the big LM without ever building
its HCLG.

TPU-first position: the framework's primary big-LM path is either
(a) building the big HCLG directly in CSR form (fst/biglang.py — fast
enough that the reference's reason for biglm decoding largely
disappears) or (b) decoding small + pruned on-demand lattice rescoring
(lattice/rescore.py).  This decoder completes the small-decoder family
for parity and serves as the oracle for those paths: token state is
(HCLG state, LM history); emitting a word w replaces the small LM's
score with the big LM's, tracked on natural-log word histories.  Total
path cost therefore equals decoding over the big-LM HCLG exactly
(weight PUSHING inside mkgraph moves scores along paths but never
changes path totals), which the tests assert.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.fst.fst import EPS, INF, VectorFst

log = get_logger(__name__)

ScoreFn = Callable[[Tuple[str, ...], str], float]


@dataclasses.dataclass
class BiglmDecoderConfig:
    beam: float = 16.0
    max_active: int = 7000
    acoustic_scale: float = 0.1
    lm_scale: float = 1.0
    history_len: int = 3        # big-LM order − 1
    bos: str = "<s>"            # decode starts in the <s> context
    eos: str = "</s>"           # final weights swap the </s> score too


class BiglmFasterDecoder:
    """Token-passing Viterbi over (HCLG state, LM history) pairs.

    `old_score`/`new_score` are natural-log LM scorers (ArpaModel.score
    signature); word ids translate through `words` (SymbolTable).  The
    on-the-fly weight on a word-emitting arc is
        lm_scale · (old_score(h_old, w) − new_score(h_new, w)),
    i.e. retract the small LM, charge the big one."""

    def __init__(self, fst: VectorFst, tid_to_pdf: np.ndarray,
                 old_score: ScoreFn, new_score: ScoreFn, words,
                 config: BiglmDecoderConfig = BiglmDecoderConfig()):
        self.fst = fst
        self.tid_to_pdf = tid_to_pdf
        self.old_score = old_score
        self.new_score = new_score
        self.words = words
        self.cfg = config

    def _lm_delta(self, hist: Tuple[str, ...], olabel: int
                  ) -> Tuple[float, Tuple[str, ...]]:
        w = self.words.find(olabel)
        delta = self.cfg.lm_scale * (self.old_score(hist, w)
                                     - self.new_score(hist, w))
        nhist = (hist + (w,))[-self.cfg.history_len:]
        return delta, nhist

    def _expand_eps(self, tokens, bp, frame):
        """ε-closure with LM tracking (ProcessNonemitting)."""
        heap = [(c, s, h) for (s, h), c in tokens.items()]
        heapq.heapify(heap)
        while heap:
            cost, s, h = heapq.heappop(heap)
            if cost > tokens.get((s, h), INF):
                continue
            for a in self.fst.arcs[s]:
                if a.ilabel != EPS:
                    continue
                nh, w = h, a.weight
                if a.olabel != EPS:
                    d, nh = self._lm_delta(h, a.olabel)
                    w += d
                nc = cost + w
                key = (a.nextstate, nh)
                if nc < tokens.get(key, INF) - 1e-12:
                    tokens[key] = nc
                    bp[(frame, key)] = (frame, (s, h), 0, a.olabel)
                    heapq.heappush(heap, (nc, a.nextstate, nh))
        return tokens

    def decode(self, loglikes: np.ndarray
               ) -> Tuple[List[int], List[int], float]:
        """loglikes (T, num_pdfs) → (tid alignment, olabels, cost)."""
        cfg = self.cfg
        T = loglikes.shape[0]
        start_key = (self.fst.start, (cfg.bos,))
        cur: Dict[Tuple[int, Tuple[str, ...]], float] = {start_key: 0.0}
        bp: Dict = {}
        cur = self._expand_eps(cur, bp, 0)
        for t in range(T):
            # beam + max-active pruning (FasterDecoder GetCutoff)
            costs = np.fromiter(cur.values(), float, len(cur))
            cutoff = costs.min() + cfg.beam
            if len(costs) > cfg.max_active:
                cutoff = min(cutoff,
                             np.partition(costs, cfg.max_active)
                             [cfg.max_active])
            nxt: Dict = {}
            for (s, h), cost in cur.items():
                if cost >= cutoff:
                    continue
                for a in self.fst.arcs[s]:
                    if a.ilabel == EPS:
                        continue
                    pdf = self.tid_to_pdf[a.ilabel]
                    ac = -cfg.acoustic_scale * loglikes[t, pdf]
                    nh, w = h, a.weight
                    if a.olabel != EPS:
                        d, nh = self._lm_delta(h, a.olabel)
                        w += d
                    nc = cost + w + ac
                    key = (a.nextstate, nh)
                    if nc < nxt.get(key, INF):
                        nxt[key] = nc
                        bp[(t + 1, key)] = (t, (s, h), a.ilabel,
                                            a.olabel)
            if not nxt:
                raise KaldiError(f"biglm decoder: no tokens at {t}")
            cur = self._expand_eps(nxt, bp, t + 1)

        best_key, best = None, INF
        for (s, h), cost in cur.items():
            fw = self.fst.final(s)
            if fw == INF:
                continue
            # the small HCLG's final weight carries small-LM </s>
            # mass; swap it for the big LM's
            fw += cfg.lm_scale * (self.old_score(h, cfg.eos)
                                  - self.new_score(h, cfg.eos))
            if cost + fw < best:
                best, best_key = cost + fw, (s, h)
        if best_key is None:
            raise KaldiError("biglm decoder: no final state reached")
        # backtrace
        tids: List[int] = []
        ols: List[int] = []
        t, key = T, best_key
        while (t, key) in bp:
            pt, pkey, tid, ol = bp[(t, key)]
            if tid:
                tids.append(tid)
            if ol:
                ols.append(ol)
            t, key = pt, pkey
        tids.reverse()
        ols.reverse()
        return tids, ols, best
