# Copied from kaldi_tpu/decoder/training_graph.py; imports rewritten to kaldi_tpu_torch.
"""Per-utterance training graph compilation.

Parity target: src/decoder/training-graph-compiler.h
(TrainingGraphCompiler::CompileGraphFromText) — build HCLG for a single
transcript: linear word acceptor ∘ L (optional silence comes from L),
determinize, compose with Ha, add self-loops.  Used by alignment
(gmm-align-compiled) and by equal-align at flat start.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.fst.fst import EPS, Arc, VectorFst
from kaldi_tpu_torch.fst.hclg import mkgraph
from kaldi_tpu_torch.fst.lang import Lang
from kaldi_tpu_torch.am.transitions import TransitionModel

log = get_logger(__name__)


def linear_word_acceptor(word_ids: Sequence[int]) -> VectorFst:
    g = VectorFst()
    cur = g.add_state()
    g.set_start(cur)
    for w in word_ids:
        nxt = g.add_state()
        g.add_arc(cur, Arc(w, w, 0.0, nxt))
        cur = nxt
    g.set_final(cur, 0.0)
    return g


class TrainingGraphCompiler:
    def __init__(self, lang: Lang, trans_model: TransitionModel,
                 transition_scale: float = 1.0, self_loop_scale: float = 0.1):
        self.lang = lang
        self.tm = trans_model
        self.transition_scale = transition_scale
        self.self_loop_scale = self_loop_scale
        self._cache = {}

    def compile_text(self, words: Sequence[str]) -> VectorFst:
        key = tuple(words)
        if key not in self._cache:
            ids = []
            for w in words:
                if w not in self.lang.words:
                    raise KaldiError(f"Word not in lexicon: {w!r}")
                ids.append(self.lang.words[w])
            G = linear_word_acceptor(ids)
            self._cache[key] = mkgraph(
                self.lang, self.tm, G,
                transition_scale=self.transition_scale,
                self_loop_scale=self.self_loop_scale)
        return self._cache[key]


def equal_align(graph: VectorFst, num_frames: int, seed: int = 0
                ) -> List[int]:
    """A valid tid path with exactly num_frames emitting arcs, self-loops
    spread evenly (bin/align-equal-compiled semantics: any valid path of
    the right length; ours distributes self-loops uniformly along the
    minimum forward path)."""
    # 0-1 BFS: min emitting arcs from each state to a final state
    from collections import deque
    S = graph.num_states
    INF_I = 10 ** 9
    dist = [INF_I] * S
    radj: List[List[tuple]] = [[] for _ in range(S)]
    for s in range(S):
        for a in graph.arcs[s]:
            if a.nextstate != s:  # ignore self-loops for the skeleton
                radj[a.nextstate].append((s, a.ilabel != EPS))
    dq = deque()
    for s in graph.finals:
        dist[s] = 0
        dq.append(s)
    while dq:
        s = dq.popleft()
        for p, emitting in radj[s]:
            nd = dist[s] + (1 if emitting else 0)
            if nd < dist[p]:
                dist[p] = nd
                if emitting:
                    dq.append(p)
                else:
                    dq.appendleft(p)
    L = dist[graph.start]
    if L > num_frames:
        raise KaldiError(
            f"equal_align: utterance too short ({num_frames} frames < "
            f"{L} emitting arcs needed)")

    # walk the min path, inserting self-loops evenly
    extra = num_frames - L
    tids: List[int] = []
    s = graph.start
    emitted = 0
    steps = 0
    opportunities = max(L, 1)
    quota_acc = 0.0
    while dist[s] > 0 or graph.final(s) == float("inf") or emitted < num_frames:
        steps += 1
        if steps > 100 * (num_frames + S + 10):
            raise KaldiError("equal_align: failed to find path")
        # pick the arc (non-self-loop) that stays on a minimal path
        best = None
        for a in graph.arcs[s]:
            if a.nextstate == s:
                continue
            need = dist[a.nextstate] + (1 if a.ilabel != EPS else 0)
            if need == dist[s]:
                best = a
                break
        if best is None:
            raise KaldiError("equal_align: dead end")
        if best.ilabel != EPS:
            emitted += 1
            tids.append(best.ilabel)
            s = best.nextstate
            # self-loops at the destination (reorder convention)
            quota_acc += extra / opportunities
            take = int(round(quota_acc))
            quota_acc -= take
            if dist[s] == 0:
                # last emitting destination: absorb all remaining frames here
                take = num_frames - emitted
            loop = next((a for a in graph.arcs[s]
                         if a.nextstate == s and a.ilabel != EPS), None)
            if loop is not None:
                for _ in range(take):
                    if emitted >= num_frames:
                        break
                    tids.append(loop.ilabel)
                    emitted += 1
        else:
            s = best.nextstate
        if emitted >= num_frames and dist[s] == 0:
            # drain remaining ε arcs to a final state
            guard = 0
            while graph.final(s) == float("inf"):
                advanced = False
                for a in graph.arcs[s]:
                    if a.ilabel == EPS and a.nextstate != s and \
                            dist[a.nextstate] == 0:
                        s = a.nextstate
                        advanced = True
                        break
                if not advanced:
                    break
                guard += 1
                if guard > S:
                    break
            break
    if emitted != num_frames:
        # pad on the last state's self-loop if possible
        loop = next((a for a in graph.arcs[s]
                     if a.nextstate == s and a.ilabel != EPS), None)
        while emitted < num_frames and loop is not None:
            tids.append(loop.ilabel)
            emitted += 1
    if emitted != num_frames:
        raise KaldiError("equal_align: could not match frame count")
    return tids
