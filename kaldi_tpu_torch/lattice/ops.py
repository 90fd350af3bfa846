# Copied from kaldi_tpu/lattice/ops.py; imports rewritten to kaldi_tpu_torch.
"""Compact-lattice structural operations.

Parity targets: src/latbin/{lattice-union,lattice-interp,lattice-push,
lattice-to-phone-lattice,lattice-equivalent}.cc and the lat/ library
functions they call (fst::PushCompactLatticeWeights,
ConvertLatticeToPhones).  All host-side graph surgery — these run per
lattice at recipe speed, off the device hot path.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

from kaldi_tpu_torch.core.logging import KaldiError
from kaldi_tpu_torch.lattice.lattice import CompactArc, CompactLattice

INF = float("inf")


def lattice_union(a: CompactLattice, b: CompactLattice) -> CompactLattice:
    """Union of two compact lattices (lattice-union.cc: fst::Union).
    New start state with free ε arcs into both operands' starts; the
    result is a valid (nondeterministic) CompactLattice."""
    out = CompactLattice()
    start = out.add_state()
    out.start = start

    def copy_in(src: CompactLattice) -> None:
        if src.start < 0:
            return
        base = out.num_states
        for _ in range(src.num_states):
            out.add_state()
        for s in range(src.num_states):
            for arc in src.arcs[s]:
                out.arcs[base + s].append(CompactArc(
                    arc.word, arc.graph_cost, arc.acoustic_cost,
                    arc.tids, base + arc.nextstate))
        for s, fin in src.finals.items():
            out.finals[base + s] = fin
        out.arcs[start].append(CompactArc(0, 0.0, 0.0, (), base + src.start))

    copy_in(a)
    copy_in(b)
    return out


def push_lattice(clat: CompactLattice) -> CompactLattice:
    """Push weights toward the start state
    (fst::PushCompactLatticeWeights role): each state's best
    (min-total) cost-to-final pair V(s) is factored out of its
    outgoing arcs, so every state's best suffix cost becomes (0, 0)
    and path weights are unchanged.  Graph/acoustic components are
    shifted by the components of the best suffix path, preserving the
    pair decomposition along every path in aggregate."""
    if clat.start < 0:
        return clat
    n = clat.num_states
    order = clat.top_order()
    # V[s] = (graph, acoustic) of the min-total path from s to a final
    vg = [INF] * n
    va = [INF] * n
    for s, (gc, ac, _) in clat.finals.items():
        vg[s], va[s] = gc, ac
    for s in reversed(order):
        for arc in clat.arcs[s]:
            t = arc.nextstate
            if vg[t] == INF:
                continue
            cg = arc.graph_cost + vg[t]
            ca = arc.acoustic_cost + va[t]
            if cg + ca < vg[s] + va[s]:
                vg[s], va[s] = cg, ca
    out = CompactLattice()
    for _ in range(n):
        out.add_state()
    out.start = clat.start
    if vg[clat.start] == INF:
        raise KaldiError("push_lattice: no path from start to a final")
    for s in range(n):
        if vg[s] == INF:
            continue
        for arc in clat.arcs[s]:
            t = arc.nextstate
            if vg[t] == INF:
                continue
            out.arcs[s].append(CompactArc(
                arc.word,
                arc.graph_cost + vg[t] - vg[s],
                arc.acoustic_cost + va[t] - va[s],
                arc.tids, t))
        if s in clat.finals:
            gc, ac, tids = clat.finals[s]
            out.finals[s] = (gc - vg[s], ac - va[s], tids)
    # the removed suffix potential re-enters at the start so total path
    # weights are exactly preserved (push-to-initial convention)
    sg, sa = vg[clat.start], va[clat.start]
    if sg != 0.0 or sa != 0.0:
        real_start = out.start
        pre = out.add_state()
        out.arcs[pre].append(CompactArc(0, sg, sa, (), real_start))
        out.start = pre
    return out


def interp_lattices(a: CompactLattice, b: CompactLattice,
                    alpha: float = 0.5) -> Optional[CompactLattice]:
    """Score interpolation by composition (lattice-interp.cc: compose
    lattice a with the reversed-role lattice b over word sequences;
    keep a's alignments).  Arc costs become alpha*cost_a + (1-alpha)*
    cost_b along matched word paths.  Returns None if the two lattices
    share no word sequence (the reference warns and outputs nothing)."""
    if a.start < 0 or b.start < 0:
        return None
    # ε-closure helpers: list of (state, graph, acoustic) reachable via
    # ε-word arcs, including self with zero cost
    def eps_closure(l: CompactLattice, s: int):
        out = [(s, 0.0, 0.0)]
        seen = {s: (0.0, 0.0)}
        stack = [(s, 0.0, 0.0)]
        while stack:
            u, g, ac = stack.pop()
            for arc in l.arcs[u]:
                if arc.word != 0:
                    continue
                ng, na = g + arc.graph_cost, ac + arc.acoustic_cost
                t = arc.nextstate
                if t not in seen or sum(seen[t]) > ng + na:
                    seen[t] = (ng, na)
                    out.append((t, ng, na))
                    stack.append((t, ng, na))
        return out

    b_closure = {s: eps_closure(b, s) for s in range(b.num_states)}

    out = CompactLattice()
    smap: Dict[Tuple[int, int], int] = {}

    def state_of(pa: int, pb: int) -> int:
        key = (pa, pb)
        if key not in smap:
            smap[key] = out.add_state()
        return smap[key]

    beta = 1.0 - alpha
    out.start = state_of(a.start, b.start)
    stack = [(a.start, b.start)]
    visited = {(a.start, b.start)}
    while stack:
        sa, sb = stack.pop()
        cur = state_of(sa, sb)
        # finals: both sides final (b reachable to final through ε)
        if sa in a.finals:
            ga, aa, tids = a.finals[sa]
            for tb, g_eps, a_eps in b_closure[sb]:
                if tb in b.finals:
                    gb, ab, _ = b.finals[tb]
                    fg = alpha * ga + beta * (gb + g_eps)
                    fa = alpha * aa + beta * (ab + a_eps)
                    old = out.finals.get(cur)
                    if old is None or old[0] + old[1] > fg + fa:
                        out.finals[cur] = (fg, fa, tids)
        for arc in a.arcs[sa]:
            if arc.word == 0:
                # a-side ε: advance a only
                nxt = state_of(arc.nextstate, sb)
                out.arcs[cur].append(CompactArc(
                    0, alpha * arc.graph_cost, alpha * arc.acoustic_cost,
                    arc.tids, nxt))
                if (arc.nextstate, sb) not in visited:
                    visited.add((arc.nextstate, sb))
                    stack.append((arc.nextstate, sb))
                continue
            for tb, g_eps, a_eps in b_closure[sb]:
                for barc in b.arcs[tb]:
                    if barc.word != arc.word:
                        continue
                    nxt = state_of(arc.nextstate, barc.nextstate)
                    out.arcs[cur].append(CompactArc(
                        arc.word,
                        alpha * arc.graph_cost
                        + beta * (barc.graph_cost + g_eps),
                        alpha * arc.acoustic_cost
                        + beta * (barc.acoustic_cost + a_eps),
                        arc.tids, nxt))
                    if (arc.nextstate, barc.nextstate) not in visited:
                        visited.add((arc.nextstate, barc.nextstate))
                        stack.append((arc.nextstate, barc.nextstate))
    if not out.finals:
        return None
    return _trim(out)


def _trim(out: CompactLattice) -> CompactLattice:
    """Remove non-coaccessible states (fst::Connect role)."""
    n = out.num_states
    co = [False] * n
    for s in out.finals:
        co[s] = True
    # reverse reachability over the DAG product (may need iteration as
    # state ids are not topological here)
    changed = True
    while changed:
        changed = False
        for s in range(n):
            if co[s]:
                continue
            for arc in out.arcs[s]:
                if co[arc.nextstate]:
                    co[s] = True
                    changed = True
                    break
    if all(co[s] or not out.arcs[s] for s in range(n)) and co[out.start]:
        trimmed = CompactLattice()
        remap = {}
        for s in range(n):
            if co[s]:
                remap[s] = trimmed.add_state()
        trimmed.start = remap[out.start]
        for s in range(n):
            if not co[s]:
                continue
            for arc in out.arcs[s]:
                if co[arc.nextstate]:
                    trimmed.arcs[remap[s]].append(CompactArc(
                        arc.word, arc.graph_cost, arc.acoustic_cost,
                        arc.tids, remap[arc.nextstate]))
        for s, fin in out.finals.items():
            trimmed.finals[remap[s]] = fin
        return trimmed
    return out


def lattice_to_phone_lattice(clat: CompactLattice, tm) -> CompactLattice:
    """Replace word labels with phone labels (ConvertLatticeToPhones
    role): each arc is split at phone boundaries of its tid string into
    one arc per phone, labeled with the phone id; the original arc's
    costs ride on the first sub-arc."""
    from kaldi_tpu_torch.lattice.word_align import _runs
    out = CompactLattice()
    for _ in range(clat.num_states):
        out.add_state()
    out.start = clat.start

    for s in range(clat.num_states):
        for arc in clat.arcs[s]:
            runs = [(p, tuple(ts)) for p, ts in _runs(tm, arc.tids)]
            if not runs:
                out.arcs[s].append(CompactArc(
                    0, arc.graph_cost, arc.acoustic_cost, (),
                    arc.nextstate))
                continue
            prev = s
            for i, (ph, tids) in enumerate(runs):
                last = i == len(runs) - 1
                nxt = arc.nextstate if last else out.add_state()
                g = arc.graph_cost if i == 0 else 0.0
                ac = arc.acoustic_cost if i == 0 else 0.0
                out.arcs[prev].append(CompactArc(ph, g, ac, tids, nxt))
                prev = nxt
    for s, fin in clat.finals.items():
        out.finals[s] = fin
    return out


def enumerate_paths(clat: CompactLattice, limit: int = 20000
                    ) -> Dict[Tuple[int, ...], float]:
    """word-sequence → min total cost over all paths (exhaustive; used
    by lattice-equivalent as the exact oracle on test-sized lattices)."""
    if clat.start < 0:
        return {}
    out: Dict[Tuple[int, ...], float] = {}
    stack = [(clat.start, (), 0.0)]
    steps = 0
    while stack:
        s, words, cost = stack.pop()
        steps += 1
        if steps > limit:
            raise KaldiError("enumerate_paths: lattice too large")
        if s in clat.finals:
            gc, ac, _ = clat.finals[s]
            total = cost + gc + ac
            if words not in out or out[words] > total:
                out[words] = total
        for arc in clat.arcs[s]:
            w = words + ((arc.word,) if arc.word else ())
            stack.append((arc.nextstate, w, cost + arc.total))
    return out


def lattices_equivalent(a: CompactLattice, b: CompactLattice,
                        delta: float = 1e-3, limit: int = 20000) -> bool:
    """Exact path-set/weight equivalence (lattice-equivalent.cc role;
    the reference uses RandEquivalent — exhaustive enumeration is the
    exact equivalent at testable sizes)."""
    pa = enumerate_paths(a, limit)
    pb = enumerate_paths(b, limit)
    if set(pa) != set(pb):
        return False
    return all(abs(pa[w] - pb[w]) <= delta for w in pa)


def lattice_confidence(clat: CompactLattice, limit: int = 200
                       ) -> float:
    """Sentence-level confidence = cost gap between the best path and
    the best path with a DIFFERENT word sequence
    (lattice-confidence.cc role).  +inf when the lattice admits only
    one word sequence."""
    from kaldi_tpu_torch.lattice.functions import nbest
    paths = nbest(clat, limit)
    if not paths:
        raise KaldiError("lattice_confidence: empty lattice")
    best_words, best_cost = paths[0]
    for words, cost in paths[1:]:
        if words != best_words:
            return cost - best_cost
    return INF
