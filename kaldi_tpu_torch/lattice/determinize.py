# Copied from kaldi_tpu/lattice/determinize.py; imports rewritten to kaldi_tpu_torch.
"""Lattice determinization: raw state-level lattice → CompactLattice.

Parity target: src/lat/determinize-lattice-pruned.h
(DeterminizeLatticePruned / DeterminizeLatticePhonePrunedWrapper):
subset determinization over word labels so each word sequence keeps
only its best-scoring path, with the per-word transition-id strings
carried along; pruning by beam against the best path.

The input raw lattice is acyclic (frame-indexed), so subsets terminate
naturally; weights are (graph, acoustic) pairs compared by total cost.
"""

from __future__ import annotations

import heapq
from collections import deque
from typing import Dict, List, Optional, Tuple

from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.lattice.lattice import (
    CompactArc,
    CompactLattice,
    INF,
    Lattice,
    LatticeArc,
)

log = get_logger(__name__)


def compact_from_arrays(res) -> CompactLattice:
    """Build a CompactLattice from the array tuple returned by
    native.determinize_lattice_native."""
    (a_src, a_word, a_next, a_gc, a_ac, tids, a_toff,
     f_st, f_gc, f_ac, f_off, n_states, start) = res
    out = CompactLattice()
    for _ in range(n_states):
        out.add_state()
    out.start = start
    for i in range(len(a_src)):
        out.arcs[int(a_src[i])].append(CompactArc(
            int(a_word[i]), float(a_gc[i]), float(a_ac[i]),
            tuple(int(t) for t in tids[a_toff[i]:a_toff[i + 1]]),
            int(a_next[i])))
    for i in range(len(f_st)):
        out.finals[int(f_st[i])] = (
            float(f_gc[i]), float(f_ac[i]),
            tuple(int(t) for t in tids[f_off[i]:f_off[i + 1]]))
    return out


def determinize_lattice(lat: Lattice, max_states: int = 200000,
                        use_native: bool = True) -> CompactLattice:
    """Word-level determinization (DeterminizeLatticePruned role).

    Dispatches to the native C++ pass (native/lattice_det.cpp) when
    available; determinize_lattice_py below is the oracle/fallback.
    """
    if use_native and lat.start >= 0:
        from kaldi_tpu_torch import native
        import numpy as np
        n = lat.num_states
        cnt = sum(len(a) for a in lat.arcs)
        src = np.empty(cnt, np.int32)
        dst = np.empty(cnt, np.int32)
        il = np.empty(cnt, np.int32)
        ol = np.empty(cnt, np.int32)
        gw = np.empty(cnt, np.float32)
        ac = np.empty(cnt, np.float32)
        k = 0
        for s, arcs in enumerate(lat.arcs):
            for a in arcs:
                src[k] = s
                dst[k] = a.nextstate
                il[k] = a.ilabel
                ol[k] = a.olabel
                gw[k] = a.graph_cost
                ac[k] = a.acoustic_cost
                k += 1
        fs = np.fromiter(lat.finals.keys(), np.int32, len(lat.finals))
        fg = np.array([w[0] for w in lat.finals.values()], np.float32)
        fa = np.array([w[1] for w in lat.finals.values()], np.float32)
        res = native.determinize_lattice_native(
            n, lat.start, src, dst, il, ol, gw, ac, fs, fg, fa,
            max_states=max_states)
        if res is not None:
            return compact_from_arrays(res)
    return determinize_lattice_py(lat, max_states)


def determinize_lattice_py(lat: Lattice, max_states: int = 200000
                           ) -> CompactLattice:
    """Word-level determinization (pure-Python oracle).

    Det-state = normalized set of (lat_state, (gc, ac) residual,
    tid-string residual).  For each word label leaving the subset, the
    best residual continuation is kept (appropriate for the tropical
    lattice semiring).
    """
    if lat.start < 0:
        return CompactLattice()

    def closure(items):
        """ε-closure over word-ε arcs (word=0), accumulating tids/costs.
        items: iterable of (state, gc, ac, tids).  Keeps the best
        (by total) entry per (state) — tid strings follow the winner."""
        best: Dict[int, Tuple[float, float, Tuple[int, ...]]] = {}
        heap = [(gc + ac, gc, ac, s, tids) for s, gc, ac, tids in items]
        heapq.heapify(heap)
        while heap:
            tot, gc, ac, s, tids = heapq.heappop(heap)
            if s in best and best[s][0] + best[s][1] <= tot:
                continue
            best[s] = (gc, ac, tids)
            for a in lat.arcs[s]:
                if a.olabel == 0:
                    ntids = tids + ((a.ilabel,) if a.ilabel else ())
                    ngc, nac = gc + a.graph_cost, ac + a.acoustic_cost
                    cur = best.get(a.nextstate)
                    if cur is None or cur[0] + cur[1] > ngc + nac:
                        heapq.heappush(heap, (ngc + nac, ngc, nac,
                                              a.nextstate, ntids))
        return best

    def normalize(closed):
        """Subtract the common best cost; strip common tid prefix."""
        min_tot = min(gc + ac for gc, ac, _ in closed.values())
        # common tid prefix across elements
        strings = [t for _, _, t in closed.values()]
        prefix = strings[0]
        for t in strings[1:]:
            i = 0
            while i < len(prefix) and i < len(t) and prefix[i] == t[i]:
                i += 1
            prefix = prefix[:i]
            if not prefix:
                break
        plen = len(prefix)
        # choose a representative split of the common cost into (gc, ac):
        # take it from the min-total element (keeps gc/ac decomposition
        # consistent along paths; total costs are exact)
        rep = min(closed.items(), key=lambda kv: kv[1][0] + kv[1][1])
        base_gc, base_ac = rep[1][0], rep[1][1]
        norm = tuple(sorted(
            (s, round(gc - base_gc, 6), round(ac - base_ac, 6), t[plen:])
            for s, (gc, ac, t) in closed.items()))
        return base_gc, base_ac, prefix, norm

    out = CompactLattice()
    det: Dict[tuple, int] = {}

    init = closure([(lat.start, 0.0, 0.0, ())])
    gc0, ac0, pre0, norm0 = normalize(init)
    s0 = out.add_state()
    out.start = s0
    det[norm0] = s0
    # initial residual (cost/tids before any word) goes onto an ε arc
    if gc0 or ac0 or pre0:
        real = out.add_state()
        out.arcs[s0].append(CompactArc(0, gc0, ac0, pre0, real))
        det[norm0] = real
        # re-point: start stays s0; norm0's state is `real`
    queue = deque([norm0])
    while queue:
        norm = queue.popleft()
        src = det[norm]
        # final weight
        fin: Optional[Tuple[float, float, Tuple[int, ...]]] = None
        for s, gc, ac, tids in norm:
            if s in lat.finals:
                fgc, fac = lat.finals[s]
                cand = (gc + fgc, ac + fac, tids)
                if fin is None or cand[0] + cand[1] < fin[0] + fin[1]:
                    fin = cand
        if fin is not None:
            out.finals[src] = fin

        by_word: Dict[int, List[Tuple[int, float, float, Tuple[int, ...]]]] = {}
        for s, gc, ac, tids in norm:
            for a in lat.arcs[s]:
                if a.olabel != 0:
                    ntids = tids + ((a.ilabel,) if a.ilabel else ())
                    by_word.setdefault(a.olabel, []).append(
                        (a.nextstate, gc + a.graph_cost,
                         ac + a.acoustic_cost, ntids))
        for word in sorted(by_word):
            closed = closure(by_word[word])
            gc, ac, prefix, nnorm = normalize(closed)
            if nnorm not in det:
                if len(det) >= max_states:
                    raise KaldiError("determinize_lattice: state blowup")
                det[nnorm] = out.add_state()
                queue.append(nnorm)
            out.arcs[src].append(
                CompactArc(word, gc, ac, prefix, det[nnorm]))
    return out


def prune_lattice(clat: CompactLattice, beam: float) -> CompactLattice:
    """Remove arcs/states whose best-through cost exceeds best + beam
    (lattice-functions.h PruneLattice)."""
    n = clat.num_states
    if n == 0 or clat.start < 0:
        return clat
    order = clat.top_order()
    fwd = [INF] * n
    fwd[clat.start] = 0.0
    for s in order:
        if fwd[s] == INF:
            continue
        for a in clat.arcs[s]:
            fwd[a.nextstate] = min(fwd[a.nextstate], fwd[s] + a.total)
    bwd = [INF] * n
    for s, (gc, ac, _) in clat.finals.items():
        bwd[s] = gc + ac
    for s in reversed(order):
        for a in clat.arcs[s]:
            bwd[s] = min(bwd[s], a.total + bwd[a.nextstate])
    costs = [fwd[s] + bwd[s] for s in range(n)
             if fwd[s] != INF and bwd[s] != INF]
    if not costs:
        # no state is both accessible and coaccessible (e.g. no reachable
        # final): the pruned lattice is empty
        return CompactLattice()
    best = min(costs)
    bound = best + beam
    keep = [s for s in range(n)
            if fwd[s] != INF and bwd[s] != INF and fwd[s] + bwd[s] <= bound]
    remap = {s: i for i, s in enumerate(keep)}
    out = CompactLattice()
    for _ in keep:
        out.add_state()
    out.start = remap.get(clat.start, -1)
    for s in keep:
        for a in clat.arcs[s]:
            if (a.nextstate in remap
                    and fwd[s] + a.total + bwd[a.nextstate] <= bound):
                out.arcs[remap[s]].append(CompactArc(
                    a.word, a.graph_cost, a.acoustic_cost, a.tids,
                    remap[a.nextstate]))
        if s in clat.finals:
            out.finals[remap[s]] = clat.finals[s]
    return out


def prune_raw_lattice(lat: Lattice, beam: float) -> Lattice:
    """α/β extra-cost pruning of a RAW lattice: keep arcs with
    α(src) + cost + β(dst) ≤ best + beam (PruneLattice /
    the retry step of DeterminizeLatticePhonePrunedWrapper)."""
    import numpy as np
    n = lat.num_states
    if lat.start < 0 or n == 0:
        return lat
    INF = float("inf")
    order = lat.top_order()
    alpha = np.full(n, INF)
    alpha[lat.start] = 0.0
    for s in order:
        if alpha[s] == INF:
            continue
        for a in lat.arcs[s]:
            c = alpha[s] + a.graph_cost + a.acoustic_cost
            if c < alpha[a.nextstate]:
                alpha[a.nextstate] = c
    beta = np.full(n, INF)
    for s, (gc, ac) in lat.finals.items():
        beta[s] = gc + ac
    for s in reversed(order):
        for a in lat.arcs[s]:
            c = a.graph_cost + a.acoustic_cost + beta[a.nextstate]
            if c < beta[s]:
                beta[s] = c
    best = beta[lat.start]          # α(start)=0 → best total path cost
    cutoff = best + beam + 1e-6     # epsilon: keep exact-tie arcs at
    #                                 beam 0 despite float re-association
    out = Lattice()
    for _ in range(n):
        out.add_state()
    out.start = lat.start
    for s in range(n):
        if alpha[s] == INF:
            continue
        for a in lat.arcs[s]:
            tot = (alpha[s] + a.graph_cost + a.acoustic_cost
                   + beta[a.nextstate])
            if tot <= cutoff:
                out.arcs[s].append(a)
    for s, f in lat.finals.items():
        if alpha[s] + f[0] + f[1] <= cutoff:
            out.finals[s] = f
    return out


def determinize_lattice_pruned(lat: Lattice, lattice_beam: float,
                               max_states: int = 200000
                               ) -> "CompactLattice":
    """DeterminizeLatticePhonePrunedWrapper's retry contract: on state
    blowup, PRUNE the raw lattice with a halved beam and determinize
    again, until it fits (the reference halves twice before giving
    up; the final attempt at beam/8 keeps at least the best path)."""
    from kaldi_tpu_torch.core.logging import KaldiError
    beam = lattice_beam
    for attempt in range(4):
        try:
            pruned = prune_raw_lattice(lat, beam) if attempt else lat
            return determinize_lattice(pruned, max_states=max_states)
        except KaldiError:
            beam = beam / 2.0
            log.warning("determinize_lattice_pruned: state blowup; "
                        "retrying with lattice-beam %.2f", beam)
    # last resort: best path only (beam 0 keeps the Viterbi path)
    return determinize_lattice(prune_raw_lattice(lat, 0.0),
                               max_states=max_states)
