# Copied from kaldi_tpu/lattice/rescore.py; imports rewritten to kaldi_tpu_torch.
"""Lattice LM rescoring.

Parity targets: src/latbin/lattice-lmrescore.cc (compose lattice with a
word-level LM FST at a given scale; scale −1 subtracts the old LM) and
src/latbin/lattice-lmrescore-const-arpa.cc with
src/lm/const-arpa-lm.h ConstArpaLmDeterministicFst (on-demand
deterministic LM automaton — here the ArpaModel trie plays the
ConstArpaLm role: a flat in-memory n-gram store queried per (history,
word) without building G).

compose_lm expands each lattice state with the LM history, adding
scale · (−log P(word|hist)) to graph costs; use scale=−1 with the old
LM then scale=+1 with the new one, exactly the reference's two-step
rescoring recipe (SURVEY.md §2 configs: '4-gram lattice rescoring').
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Dict, Optional, Tuple

from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.fst.arpa import ArpaModel
from kaldi_tpu_torch.fst.fst import SymbolTable
from kaldi_tpu_torch.lattice.lattice import CompactArc, CompactLattice

log = get_logger(__name__)


def compose_lm(clat: CompactLattice,
               score_fn: Callable[[Tuple[str, ...], str], float],
               words: SymbolTable, scale: float = 1.0,
               bos: str = "<s>", eos: str = "</s>",
               max_states: int = 1_000_000) -> CompactLattice:
    """Compose with a deterministic on-demand LM.

    score_fn(history_words, word) → natural-log probability.  The output
    lattice's states are (lattice state, LM history) pairs; graph costs
    gain  −scale · log P(word | history); final states gain the eos
    probability.
    """
    if clat.start < 0:
        return clat
    out = CompactLattice()
    state_map: Dict[Tuple[int, Tuple[str, ...]], int] = {}

    def get(ls: int, hist: Tuple[str, ...]) -> int:
        key = (ls, hist)
        if key not in state_map:
            if len(state_map) >= max_states:
                raise KaldiError("compose_lm: state blowup")
            state_map[key] = out.add_state()
        return state_map[key]

    start_key = (clat.start, (bos,))
    out.start = get(*start_key)
    queue = deque([start_key])
    seen = {start_key}
    while queue:
        ls, hist = queue.popleft()
        src = state_map[(ls, hist)]
        if ls in clat.finals:
            gc, ac, tids = clat.finals[ls]
            eos_lp = score_fn(hist, eos)
            out.finals[src] = (gc - scale * eos_lp, ac, tids)
        for a in clat.arcs[ls]:
            if a.word == 0:
                nhist = hist
                add = 0.0
            else:
                wstr = words.find(a.word)
                add = -scale * score_fn(hist, wstr)
                nhist = hist + (wstr,)
                nhist = nhist[-8:]  # history cap; score_fn truncates anyway
            nk = (a.nextstate, nhist)
            dst = get(*nk)
            out.arcs[src].append(CompactArc(
                a.word, a.graph_cost + add, a.acoustic_cost, a.tids, dst))
            if nk not in seen:
                seen.add(nk)
                queue.append(nk)
    return out


def lmrescore(clat: CompactLattice, old_lm: ArpaModel, new_lm: ArpaModel,
              words: SymbolTable, lm_scale: float = 1.0) -> CompactLattice:
    """Two-step rescoring: subtract the old G scores, add the new LM
    (lattice-lmrescore --lm-scale=-1 + lattice-lmrescore-const-arpa)."""
    no_old = compose_lm(clat, old_lm.score, words, scale=-lm_scale)
    return compose_lm(no_old, new_lm.score, words, scale=lm_scale)


def _min_beta(clat: CompactLattice):
    """Min (graph+acoustic) cost from each state to a final state."""
    import numpy as np
    order = clat.top_order()
    beta = np.full(clat.num_states, float("inf"))
    for s, (gc, ac, _) in clat.finals.items():
        beta[s] = gc + ac
    for s in reversed(order):
        for a in clat.arcs[s]:
            c = a.graph_cost + a.acoustic_cost + beta[a.nextstate]
            if c < beta[s]:
                beta[s] = c
    return beta


def compose_lm_pruned(clat: CompactLattice,
                      score_fn: Callable[[Tuple[str, ...], str], float],
                      words: SymbolTable, scale: float = 1.0,
                      beam: float = 6.0, max_arcs: int = 100_000,
                      bos: str = "<s>", eos: str = "</s>") -> CompactLattice:
    """Pruned on-demand composition with a deterministic LM — the
    src/lat/compose-lattice-pruned.h ComposeCompactLatticePruned role
    (lattice-lmrescore-pruned / RNNLM rescoring of big lattices).

    Best-first A*-style expansion of (lattice-state, LM-history) pairs:
    priority = cost arrived at the composed state + the ORIGINAL
    lattice's min remaining cost (an admissible heuristic when the LM
    addition is nonnegative, a good guide otherwise).  A composed state
    is expanded only while its priority is within `beam` of the best
    completed path found so far and fewer than `max_arcs` arcs have
    been emitted — so large lattices rescore in time bounded by the
    output size, not the cross-product.  The best path is expanded
    first, so it always survives.  Unreachable dead ends left by the
    cutoff are trimmed before returning.
    """
    import heapq
    if clat.start < 0:
        return clat
    beta = _min_beta(clat)
    out = CompactLattice()
    state_map: Dict[Tuple[int, Tuple[str, ...]], int] = {}
    fwd: Dict[int, float] = {}

    def get(ls: int, hist: Tuple[str, ...]) -> int:
        key = (ls, hist)
        if key not in state_map:
            state_map[key] = out.add_state()
        return state_map[key]

    start_key = (clat.start, (bos,))
    out.start = get(*start_key)
    fwd[out.start] = 0.0
    # heap of (priority, composed-state id, lattice state, history)
    heap = [(beta[clat.start], out.start, clat.start, (bos,))]
    expanded = set()
    best_completed = float("inf")
    n_arcs = 0
    while heap:
        pri, src, ls, hist = heapq.heappop(heap)
        if src in expanded:
            continue
        if pri > best_completed + beam:
            break
        # the arc cap only binds once a complete path exists — the best
        # path must always survive (the reference grows the output until
        # the composition has a final state for the same reason)
        if n_arcs >= max_arcs and best_completed < float("inf"):
            break
        expanded.add(src)
        base = fwd[src]
        if ls in clat.finals:
            gc, ac, tids = clat.finals[ls]
            eos_add = -scale * score_fn(hist, eos)
            out.finals[src] = (gc + eos_add, ac, tids)
            best_completed = min(best_completed,
                                 base + gc + ac + eos_add)
        for a in clat.arcs[ls]:
            if a.word == 0:
                nhist, add = hist, 0.0
            else:
                wstr = words.find(a.word)
                add = -scale * score_fn(hist, wstr)
                nhist = (hist + (wstr,))[-8:]
            cost = base + a.graph_cost + a.acoustic_cost + add
            est = cost + beta[a.nextstate]
            if est > best_completed + beam:
                continue
            dst = get(a.nextstate, nhist)
            out.arcs[src].append(CompactArc(
                a.word, a.graph_cost + add, a.acoustic_cost, a.tids, dst))
            n_arcs += 1
            if dst not in expanded and cost < fwd.get(dst, float("inf")):
                fwd[dst] = cost
                heapq.heappush(heap, (est, dst, a.nextstate, nhist))
    return _connect(out)


def _connect(out: CompactLattice) -> CompactLattice:
    """Trim states that cannot reach a final state (and unreachable
    ones), preserving state order."""
    if out.start < 0:
        return out
    n = out.num_states
    coacc = [False] * n
    for s in out.finals:
        coacc[s] = True
    # reverse reachability by iterating until fixpoint (lattices from
    # compose are near-topological; a few sweeps suffice)
    changed = True
    while changed:
        changed = False
        for s in range(n):
            if coacc[s]:
                continue
            for a in out.arcs[s]:
                if coacc[a.nextstate]:
                    coacc[s] = True
                    changed = True
                    break
    acc = [False] * n
    stack = [out.start]
    acc[out.start] = True
    while stack:
        s = stack.pop()
        for a in out.arcs[s]:
            if coacc[a.nextstate] and not acc[a.nextstate]:
                acc[a.nextstate] = True
                stack.append(a.nextstate)
    keep = [s for s in range(n) if acc[s] and coacc[s]]
    remap = {s: i for i, s in enumerate(keep)}
    trimmed = CompactLattice()
    for _ in keep:
        trimmed.add_state()
    trimmed.start = remap.get(out.start, -1)
    for s in keep:
        for a in out.arcs[s]:
            if a.nextstate in remap:
                trimmed.arcs[remap[s]].append(CompactArc(
                    a.word, a.graph_cost, a.acoustic_cost, a.tids,
                    remap[a.nextstate]))
        if s in out.finals:
            trimmed.finals[remap[s]] = out.finals[s]
    return trimmed


def lmrescore_pruned(clat: CompactLattice, old_lm: ArpaModel,
                     new_lm, words: SymbolTable, lm_scale: float = 1.0,
                     beam: float = 6.0,
                     max_arcs: int = 100_000) -> CompactLattice:
    """Subtract the old G exactly, add the new LM with pruned
    composition (lattice-lmrescore-pruned: ConstArpa or RNNLM as
    new_lm — anything with .score(history, word))."""
    no_old = compose_lm(clat, old_lm.score, words, scale=-lm_scale)
    return compose_lm_pruned(no_old, new_lm.score, words, scale=lm_scale,
                             beam=beam, max_arcs=max_arcs)


def lmrescore_diff_pruned(clat: CompactLattice, old_lm: ArpaModel,
                          new_lm, words: SymbolTable,
                          lm_scale: float = 1.0, beam: float = 6.0,
                          max_arcs: int = 200_000) -> CompactLattice:
    """ONE pruned composition with the DIFFERENCE LM: graph costs gain
    lm_scale · (−log P_new + log P_old) per word.  Semantically the
    lattice-lmrescore(−1) → lattice-lmrescore-const-arpa pipeline, but
    the exact intermediate (which is quadratic in lattice density ×
    old-LM histories and blows up on dense lattices) is never built —
    the pruned A* expands (lattice-state, history) pairs under the
    COMBINED score, so pruning is guided by the final costs.  History
    length is the max of the two orders (compose_lm truncates per
    query).  new_lm is anything with .score(history, word) — ArpaModel
    trie (const-arpa role) or an RNNLM state-carrying scorer.

    Approximation contract (same as the reference's
    ComposeCompactLatticePruned): the search heuristic is the ORIGINAL
    lattice's backward cost, which does not see future LM deltas — a
    prefix whose suffix the new LM strongly prefers (large negative
    diff later) can be pruned once some path has completed within
    `beam`.  The reference's pruned composition has the identical
    blind spot (its backward costs predate the new LM too); widen
    `beam` when exactness matters more than time."""
    def diff(hist, w):
        return new_lm.score(hist, w) - old_lm.score(hist, w)
    return compose_lm_pruned(clat, diff, words, scale=lm_scale,
                             beam=beam, max_arcs=max_arcs)
