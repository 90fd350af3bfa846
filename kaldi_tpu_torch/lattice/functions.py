# Copied from kaldi_tpu/lattice/functions.py; imports rewritten to kaldi_tpu_torch.
"""Lattice algorithms: scaling, N-best, posteriors, times, MBR.

Parity targets: src/lat/lattice-functions.h (ScaleLattice,
LatticeForwardBackward, CompactLatticeShortestPath, LatticeStateTimes,
arc posteriors), src/latbin/lattice-to-nbest.cc, src/lat/sausages.h
(MinimumBayesRisk — confusion-network / sausage decoding).
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.lattice.lattice import CompactArc, CompactLattice, INF

log = get_logger(__name__)


def scale_lattice(clat: CompactLattice, lm_scale: float = 1.0,
                  acoustic_scale: float = 1.0) -> CompactLattice:
    """ScaleLattice: multiply graph/acoustic costs (in place, returns it)."""
    for arcs in clat.arcs:
        for a in arcs:
            a.graph_cost *= lm_scale
            a.acoustic_cost *= acoustic_scale
    for s in list(clat.finals):
        gc, ac, t = clat.finals[s]
        clat.finals[s] = (gc * lm_scale, ac * acoustic_scale, t)
    return clat


def best_path_scaled(clat: CompactLattice, lm_scale: float = 1.0,
                     acoustic_scale: float = 1.0) -> Tuple[List[int],
                                                           float]:
    """Best word sequence under scaled costs WITHOUT mutating the
    lattice — the scoring-time `lattice-scale --lm-scale=$LMWT |
    lattice-best-path` sweep (steps/score.sh runs it for every LMWT;
    RESULTS reports the best).  Returns (word ids, scaled cost)."""
    if clat.start < 0:
        return [], 0.0
    order = clat.top_order()
    best = [INF] * clat.num_states
    back: List[Optional[Tuple[int, int]]] = [None] * clat.num_states
    best[clat.start] = 0.0
    for s in order:
        if best[s] == INF:
            continue
        for a in clat.arcs[s]:
            c = best[s] + lm_scale * a.graph_cost \
                + acoustic_scale * a.acoustic_cost
            if c < best[a.nextstate]:
                best[a.nextstate] = c
                back[a.nextstate] = (s, a.word)
    fbest, fstate = INF, -1
    for s, (gc, ac, _) in clat.finals.items():
        c = best[s] + lm_scale * gc + acoustic_scale * ac
        if c < fbest:
            fbest, fstate = c, s
    if fstate < 0:            # no reachable final state: empty, inf
        return [], INF
    words: List[int] = []
    s = fstate
    while s != clat.start and back[s] is not None:
        prev, w = back[s]
        if w:
            words.append(w)
        s = prev
    words.reverse()
    return words, fbest


def nbest(clat: CompactLattice, n: int) -> List[Tuple[List[int], float]]:
    """N best distinct paths (word seq, cost) via A* on the DAG with the
    exact backward heuristic (lattice-to-nbest semantics)."""
    if clat.start < 0:
        return []
    order = clat.top_order()
    bwd = [INF] * clat.num_states
    for s, (gc, ac, _) in clat.finals.items():
        bwd[s] = gc + ac
    for s in reversed(order):
        for a in clat.arcs[s]:
            bwd[s] = min(bwd[s], a.total + bwd[a.nextstate])
    out: List[Tuple[List[int], float]] = []
    # heap of (f = g + h, counter, state, g, words)
    cnt = 0
    heap = [(bwd[clat.start], cnt, clat.start, 0.0, [])]
    while heap and len(out) < n:
        f, _, s, g, words = heapq.heappop(heap)
        if s in clat.finals:
            gc, ac, _ = clat.finals[s]
            out.append((words, g + gc + ac))
        for a in clat.arcs[s]:
            ng = g + a.total
            if bwd[a.nextstate] == INF:
                continue
            cnt += 1
            heapq.heappush(heap, (ng + bwd[a.nextstate], cnt, a.nextstate,
                                  ng, words + ([a.word] if a.word else [])))
    return out


def nbest_paths(clat: CompactLattice, n: int
                ) -> List[Tuple[List[CompactArc], Tuple[float, float, tuple],
                                float]]:
    """N best paths with their arcs: (arc list, final (gc, ac, tids),
    total cost) per path — enough to rebuild a single-path
    CompactLattice per hypothesis (lattice-to-nbest writes these)."""
    if clat.start < 0:
        return []
    order = clat.top_order()
    bwd = [INF] * clat.num_states
    for s, (gc, ac, _) in clat.finals.items():
        bwd[s] = gc + ac
    for s in reversed(order):
        for a in clat.arcs[s]:
            bwd[s] = min(bwd[s], a.total + bwd[a.nextstate])
    out = []
    cnt = 0
    heap = [(bwd[clat.start], cnt, clat.start, 0.0, [])]
    while heap and len(out) < n:
        f, _, s, g, arcs = heapq.heappop(heap)
        if s in clat.finals:
            fin = clat.finals[s]
            out.append((arcs, fin, g + fin[0] + fin[1]))
        for a in clat.arcs[s]:
            if bwd[a.nextstate] == INF:
                continue
            cnt += 1
            heapq.heappush(heap, (g + a.total + bwd[a.nextstate], cnt,
                                  a.nextstate, g + a.total, arcs + [a]))
    return out


def path_to_lattice(arcs: List[CompactArc],
                    final: Tuple[float, float, tuple]) -> CompactLattice:
    """One linear path → a single-path CompactLattice."""
    out = CompactLattice()
    out.start = out.add_state()
    cur = out.start
    for a in arcs:
        nxt = out.add_state()
        out.arcs[cur].append(CompactArc(a.word, a.graph_cost,
                                        a.acoustic_cost, tuple(a.tids), nxt))
        cur = nxt
    out.finals[cur] = (final[0], final[1], tuple(final[2]))
    return out


def forward_backward_post(clat: CompactLattice, acoustic_scale: float = 1.0,
                          lm_scale: float = 1.0):
    """Log-domain sum forward-backward → per-arc posterior probabilities.
    Returns (arc_post: {(state, arc_idx): prob}, total log-like)."""
    if clat.start < 0:
        return {}, -INF
    order = clat.top_order()
    n = clat.num_states

    def arc_loglike(a: CompactArc) -> float:
        return -(a.graph_cost * lm_scale + a.acoustic_cost * acoustic_scale)

    alpha = [-INF] * n
    alpha[clat.start] = 0.0
    for s in order:
        if alpha[s] == -INF:
            continue
        for a in clat.arcs[s]:
            v = alpha[s] + arc_loglike(a)
            alpha[a.nextstate] = np.logaddexp(alpha[a.nextstate], v)
    beta = [-INF] * n
    for s, (gc, ac, _) in clat.finals.items():
        beta[s] = -(gc * lm_scale + ac * acoustic_scale)
    for s in reversed(order):
        for a in clat.arcs[s]:
            beta[s] = np.logaddexp(beta[s],
                                   arc_loglike(a) + beta[a.nextstate])
    total = beta[clat.start]
    post: Dict[Tuple[int, int], float] = {}
    for s in range(n):
        if alpha[s] == -INF:
            continue
        for i, a in enumerate(clat.arcs[s]):
            lp = alpha[s] + arc_loglike(a) + beta[a.nextstate] - total
            post[(s, i)] = math.exp(min(lp, 0.0))
    return post, total


def frame_posteriors(clat: CompactLattice, acoustic_scale: float = 1.0
                     ) -> List[List[Tuple[int, float]]]:
    """Per-frame transition-id posteriors from a CompactLattice
    (latbin/lattice-to-post.cc LatticeForwardBackward flow): arc
    posteriors spread over each arc's tid string by state time."""
    post, _total = forward_backward_post(clat,
                                         acoustic_scale=acoustic_scale)
    times = state_times(clat)
    T = max((times[s] + len(a.tids)
             for s in range(clat.num_states)
             for a in clat.arcs[s]), default=0)
    frames: List[Dict[int, float]] = [dict() for _ in range(T)]
    for s in range(clat.num_states):
        for i, a in enumerate(clat.arcs[s]):
            p = post.get((s, i), 0.0)
            if p <= 0:
                continue
            for k, tid in enumerate(a.tids):
                t = times[s] + k
                frames[t][tid] = frames[t].get(tid, 0.0) + p
    return [sorted(fr.items()) for fr in frames]


def state_times(clat: CompactLattice) -> List[int]:
    """Frame index of each compact-lattice state (CompactLatticeStateTimes:
    arcs advance time by the length of their tid string)."""
    order = clat.top_order()
    times = [-1] * clat.num_states
    times[clat.start] = 0
    for s in order:
        if times[s] < 0:
            continue
        for a in clat.arcs[s]:
            t = times[s] + len(a.tids)
            if times[a.nextstate] >= 0 and times[a.nextstate] != t:
                # lattices need not be 'aligned'; keep the max (ref warns)
                t = max(t, times[a.nextstate])
            times[a.nextstate] = t
    return times


@dataclasses.dataclass
class MbrResult:
    words: List[int]
    times: List[Tuple[int, int]]        # (begin, end) frame per word
    confidences: List[float]
    bayes_risk: float


def mbr_decode(clat: CompactLattice, acoustic_scale: float = 1.0,
               lm_scale: float = 1.0, max_iters: int = 4) -> MbrResult:
    """Minimum-Bayes-Risk (sausage) decoding — src/lat/sausages.h
    MinimumBayesRisk: start from the MAP hypothesis, iteratively apply
    the Goel & Byrne statistical alignment to minimize expected WER.

    Implementation: collapse the lattice to N-best (capped), compute
    path posteriors, then iteratively re-align hypotheses against the
    current consensus using Levenshtein alignment weighted by posterior.
    """
    paths = nbest(clat, 100)
    if not paths:
        raise KaldiError("mbr_decode: empty lattice")
    # posterior over paths under the scaled distribution
    costs = np.array([c for _, c in paths])
    logp = -(costs - costs.min())
    p = np.exp(logp)
    p /= p.sum()
    hyps = [w for w, _ in paths]

    # initial consensus = MAP path
    consensus = list(hyps[0])
    for _ in range(max_iters):
        # align every hyp to consensus; vote per position
        L = len(consensus)
        votes: List[Dict[int, float]] = [dict() for _ in range(L + 1)]
        # votes[i] for insertions between positions handled coarsely: we
        # track substitutions/deletions per consensus slot
        slot_votes: List[Dict[int, float]] = [dict() for _ in range(L)]
        for hyp, prob in zip(hyps, p):
            al = _levenshtein_align(consensus, hyp)
            for i, w in al:
                if i is not None:
                    d = slot_votes[i]
                    d[w or 0] = d.get(w or 0, 0.0) + prob
        new_consensus = []
        for i in range(L):
            if not slot_votes[i]:
                continue
            w = max(slot_votes[i].items(), key=lambda kv: kv[1])[0]
            if w != 0:
                new_consensus.append(w)
        if new_consensus == consensus:
            break
        consensus = new_consensus

    # confidences: posterior mass of the winning word per slot
    confidences = []
    L = len(consensus)
    slot_votes = [dict() for _ in range(L)]
    for hyp, prob in zip(hyps, p):
        al = _levenshtein_align(consensus, hyp)
        for i, w in al:
            if i is not None:
                d = slot_votes[i]
                d[w or 0] = d.get(w or 0, 0.0) + prob
    for i, w in enumerate(consensus):
        tot = sum(slot_votes[i].values()) or 1.0
        confidences.append(slot_votes[i].get(w, 0.0) / tot)
    # expected WER of consensus
    risk = 0.0
    for hyp, prob in zip(hyps, p):
        d = _edit_dist(consensus, hyp)
        risk += prob * d
    # crude times: spread evenly (real times need tid strings; see
    # state_times for aligned lattices)
    times = [(i, i + 1) for i in range(len(consensus))]
    return MbrResult(consensus, times, confidences, risk)


def _edit_dist(a, b) -> int:
    la, lb = len(a), len(b)
    dp = list(range(lb + 1))
    for i in range(1, la + 1):
        prev = dp[0]
        dp[0] = i
        for j in range(1, lb + 1):
            cur = dp[j]
            dp[j] = min(dp[j] + 1, dp[j - 1] + 1,
                        prev + (0 if a[i - 1] == b[j - 1] else 1))
            prev = cur
    return dp[lb]


def _levenshtein_align(ref, hyp):
    """Alignment [(ref_pos or None, hyp_word or 0)] — substitutions and
    deletions map to ref slots; insertions get ref_pos None."""
    R, H = len(ref), len(hyp)
    dp = np.zeros((R + 1, H + 1))
    dp[:, 0] = np.arange(R + 1)
    dp[0, :] = np.arange(H + 1)
    for i in range(1, R + 1):
        for j in range(1, H + 1):
            dp[i, j] = min(dp[i - 1, j] + 1, dp[i, j - 1] + 1,
                           dp[i - 1, j - 1]
                           + (0 if ref[i - 1] == hyp[j - 1] else 1))
    out = []
    i, j = R, H
    while i > 0 or j > 0:
        if i > 0 and j > 0 and dp[i, j] == dp[i - 1, j - 1] + (
                0 if ref[i - 1] == hyp[j - 1] else 1):
            out.append((i - 1, hyp[j - 1]))
            i -= 1
            j -= 1
        elif i > 0 and dp[i, j] == dp[i - 1, j] + 1:
            out.append((i - 1, 0))      # deletion: ref slot got nothing
            i -= 1
        else:
            out.append((None, hyp[j - 1]))  # insertion
            j -= 1
    out.reverse()
    return out


def oracle_errors(clat: CompactLattice, ref: Sequence[int]) -> int:
    """Minimum edit distance between ``ref`` and ANY path of the
    lattice — the oracle-WER numerator (latbin/lattice-oracle.cc,
    which composes the lattice with an edit-distance transducer; here
    a vectorized DP over (state, ref-position) with the j-axis as one
    numpy row per state, fast enough to score thousands of bench
    lattices)."""
    if clat.start < 0:
        return len(ref)
    ref_arr = np.asarray(list(ref), np.int64)
    m = len(ref_arr)
    INF_I = np.int64(1 << 30)
    D = np.full((clat.num_states, m + 1), INF_I, np.int64)
    D[clat.start, 0] = 0
    idx = np.arange(m + 1, dtype=np.int64)

    def del_closure(row):
        # deletions consume ref words in place:
        # D[j] = min_k<=j D[k] + (j - k)  (prefix min of D[k]-k, + j)
        return np.minimum(row, np.minimum.accumulate(row - idx) + idx)

    best = INF_I
    for s in clat.top_order():
        row = del_closure(D[s])
        D[s] = row
        fin = clat.finals.get(s)
        if fin is not None:
            best = min(best, row[m])
        for a in clat.arcs[s]:
            if a.word == 0:
                cand = row
            else:
                ins = row + 1                         # hyp word inserted
                sub = np.empty(m + 1, np.int64)
                sub[0] = INF_I
                sub[1:] = row[:-1] + (ref_arr != a.word)
                cand = np.minimum(ins, sub)
            np.minimum(D[a.nextstate], cand, out=D[a.nextstate])
    return int(best)


def lattice_depth(clat: CompactLattice) -> Tuple[int, int]:
    """(total frames crossed by arcs, lattice frame count) — the
    lattice-depth statistic (latbin/lattice-depth.cc: density = arcs'
    tid-frames / utterance frames; 1.0 means a linear lattice)."""
    times = state_times(clat)
    frames = sum(len(a.tids) for arcs in clat.arcs for a in arcs)
    frames += sum(len(f[2]) for f in clat.finals.values())
    T = max((times[s] + len(f[2]) for s, f in clat.finals.items()),
            default=0)
    return frames, T
