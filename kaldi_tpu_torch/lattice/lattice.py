# Copied from kaldi_tpu/lattice/lattice.py; imports rewritten to kaldi_tpu_torch.
"""Lattice types.

Parity target: src/lat/kaldi-lattice.h — Lattice (state-level, arc
weights are (graph_cost, acoustic_cost) LatticeWeight pairs, ilabels
are transition-ids, olabels words) and CompactLattice (word acceptor
whose arcs carry (LatticeWeight, transition-id string)).

Semiring: LatticeWeight comparison is by TOTAL cost (graph+acoustic),
ties broken on graph cost — src/fstext/lattice-weight.h Compare().
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from kaldi_tpu_torch.core.logging import KaldiError

INF = float("inf")


def lat_less(a: Tuple[float, float], b: Tuple[float, float]) -> bool:
    """LatticeWeight 'better-than' (lattice-weight.h Compare)."""
    ta, tb = a[0] + a[1], b[0] + b[1]
    if ta != tb:
        return ta < tb
    return a[0] < b[0]


@dataclasses.dataclass
class LatticeArc:
    ilabel: int                 # transition-id (0 = ε)
    olabel: int                 # word (0 = ε)
    graph_cost: float
    acoustic_cost: float
    nextstate: int

    @property
    def total(self) -> float:
        return self.graph_cost + self.acoustic_cost


class Lattice:
    """State-level raw lattice (acyclic)."""

    def __init__(self):
        self.start = -1
        self.arcs: List[List[LatticeArc]] = []
        self.finals: Dict[int, Tuple[float, float]] = {}

    def add_state(self) -> int:
        self.arcs.append([])
        return len(self.arcs) - 1

    def set_final(self, s: int, graph_cost: float = 0.0,
                  acoustic_cost: float = 0.0) -> None:
        self.finals[s] = (graph_cost, acoustic_cost)

    @property
    def num_states(self) -> int:
        return len(self.arcs)

    @property
    def num_arcs(self) -> int:
        return sum(len(a) for a in self.arcs)

    def best_path(self) -> Tuple[List[int], List[int], float]:
        """(tids, words, total cost) via DAG shortest path."""
        order = self.top_order()
        dist = [INF] * self.num_states
        back: List[Optional[Tuple[int, LatticeArc]]] = [None] * self.num_states
        dist[self.start] = 0.0
        for s in order:
            if dist[s] == INF:
                continue
            for a in self.arcs[s]:
                nd = dist[s] + a.total
                if nd < dist[a.nextstate]:
                    dist[a.nextstate] = nd
                    back[a.nextstate] = (s, a)
        best_s, best = -1, INF
        for s, (gc, ac) in self.finals.items():
            if dist[s] + gc + ac < best:
                best = dist[s] + gc + ac
                best_s = s
        if best_s < 0:
            raise KaldiError("Lattice.best_path: no final state")
        tids: List[int] = []
        words: List[int] = []
        s = best_s
        while s != self.start:
            ps, a = back[s]  # type: ignore
            if a.ilabel:
                tids.append(a.ilabel)
            if a.olabel:
                words.append(a.olabel)
            s = ps
        tids.reverse()
        words.reverse()
        return tids, words, best

    def top_order(self) -> List[int]:
        n = self.num_states
        indeg = [0] * n
        for arcs in self.arcs:
            for a in arcs:
                indeg[a.nextstate] += 1
        from collections import deque
        q = deque([s for s in range(n) if indeg[s] == 0])
        order = []
        while q:
            s = q.popleft()
            order.append(s)
            for a in self.arcs[s]:
                indeg[a.nextstate] -= 1
                if indeg[a.nextstate] == 0:
                    q.append(a.nextstate)
        if len(order) != n:
            raise KaldiError("Lattice has a cycle")
        return order


@dataclasses.dataclass
class CompactArc:
    word: int
    graph_cost: float
    acoustic_cost: float
    tids: Tuple[int, ...]
    nextstate: int

    @property
    def total(self) -> float:
        return self.graph_cost + self.acoustic_cost


class CompactLattice:
    """Word-level deterministic lattice (acceptor over words; each arc
    carries the LatticeWeight pair and its tid string)."""

    def __init__(self):
        self.start = -1
        self.arcs: List[List[CompactArc]] = []
        # final: (graph, acoustic, tid string) — final tid strings arise
        # from paths ending in ε/silence tids after the last word
        self.finals: Dict[int, Tuple[float, float, Tuple[int, ...]]] = {}

    def add_state(self) -> int:
        self.arcs.append([])
        return len(self.arcs) - 1

    @property
    def num_states(self) -> int:
        return len(self.arcs)

    @property
    def num_arcs(self) -> int:
        return sum(len(a) for a in self.arcs)

    def top_order(self) -> List[int]:
        n = self.num_states
        indeg = [0] * n
        for arcs in self.arcs:
            for a in arcs:
                indeg[a.nextstate] += 1
        from collections import deque
        q = deque([s for s in range(n) if indeg[s] == 0])
        order = []
        while q:
            s = q.popleft()
            order.append(s)
            for a in self.arcs[s]:
                indeg[a.nextstate] -= 1
                if indeg[a.nextstate] == 0:
                    q.append(a.nextstate)
        if len(order) != n:
            raise KaldiError("CompactLattice has a cycle")
        return order

    def best_path(self) -> Tuple[List[int], List[int], float]:
        """(words, tids, total cost)."""
        order = self.top_order()
        dist = [INF] * self.num_states
        back: List[Optional[Tuple[int, CompactArc]]] = [None] * self.num_states
        dist[self.start] = 0.0
        for s in order:
            if dist[s] == INF:
                continue
            for a in self.arcs[s]:
                nd = dist[s] + a.total
                if nd < dist[a.nextstate]:
                    dist[a.nextstate] = nd
                    back[a.nextstate] = (s, a)
        best_s, best = -1, INF
        for s, (gc, ac, _) in self.finals.items():
            if dist[s] + gc + ac < best:
                best = dist[s] + gc + ac
                best_s = s
        if best_s < 0:
            raise KaldiError("CompactLattice.best_path: no final state")
        words: List[int] = []
        tids: List[int] = []
        s = best_s
        rev: List[CompactArc] = []
        while s != self.start:
            ps, a = back[s]  # type: ignore
            rev.append(a)
            s = ps
        for a in reversed(rev):
            if a.word:
                words.append(a.word)
            tids.extend(a.tids)
        tids.extend(self.finals[best_s][2])
        return words, tids, best

    def paths(self, max_paths: int = 10000) -> List[Tuple[Tuple[int, ...], float]]:
        """All (word sequence, total cost) pairs — small lattices only."""
        out: List[Tuple[Tuple[int, ...], float]] = []

        def walk(s, words, cost):
            if len(out) >= max_paths:
                return
            if s in self.finals:
                gc, ac, _ = self.finals[s]
                out.append((tuple(words), cost + gc + ac))
            for a in self.arcs[s]:
                walk(a.nextstate, words + ([a.word] if a.word else []),
                     cost + a.total)

        walk(self.start, [], 0.0)
        return out


def compact_to_lattice(clat: CompactLattice) -> Lattice:
    """CompactLattice → state-level raw Lattice: each arc's tid string
    expands to a chain of one-frame arcs (fst::ConvertLattice's
    inverse direction, src/lat/kaldi-lattice.h); the (graph, acoustic)
    weight and the word label ride the first expanded arc."""
    out = Lattice()
    for _ in range(clat.num_states):
        out.add_state()
    out.start = clat.start

    def expand(src: int, dst, word, gc, ac, tids, final=False):
        cur = src
        n = len(tids)
        if n == 0:
            if final:
                out.set_final(cur, gc, ac)
            else:
                out.arcs[cur].append(LatticeArc(0, word, gc, ac, dst))
            return
        for i, tid in enumerate(tids):
            last = i == n - 1
            nxt = (out.add_state() if (not last or final)
                   else dst)
            out.arcs[cur].append(LatticeArc(
                int(tid), word if i == 0 else 0,
                gc if i == 0 else 0.0, ac if i == 0 else 0.0, nxt))
            cur = nxt
        if final:
            out.set_final(cur, 0.0, 0.0)

    for s in range(clat.num_states):
        for a in clat.arcs[s]:
            expand(s, a.nextstate, a.word, a.graph_cost,
                   a.acoustic_cost, a.tids)
    for s, (gc, ac, ftids) in clat.finals.items():
        expand(s, None, 0, gc, ac, ftids, final=True)
    return out
